"""Port parity of int8 weight-streaming serving (``store_int8``): the four
tests of ``tests/test_int8_serving.py`` held against the JAX package on
the same inputs (numpy seeds and the weight bridge), plus the int8 K3
kernel on the card.

Tolerances: ``quantize_tree_for_serving``'s levels and scales bit-equal to
JAX's; ``emt_dense`` outputs within 1e-6 relative (float32 matmul order)
and its aux within rtol 1e-5 (float32 |w| and |level| sums over a
thousand-odd elements in another order: 1.0e-6 measured on the energy),
cell counts equal; the smoke engine's tokens identical to
JAX's and its ledgers within rtol 1e-5 (the contiguous-engine tests'
gate); on the card, the int8 kernel within 1e-5 relative of its plain
version (float32 sum order), two calls and the noisy weight (x = I) bit
for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.core import emt_linear as jel
from repro.models import lm as jlm
from repro.nn.param import abstract_params, init_params
from repro.serve.engine import GenRequest as JReq
from repro.serve.engine import ServingEngine as JEng
from repro.serve.spec import ServeSpec as JSpec
from repro_torch.core import emt_linear as tel
from repro_torch.core.device import DeviceModel, four_state_device
from repro_torch.kernels import emt_matmul as k3
from repro_torch.kernels.ref import dequantize
from repro_torch.models import lm as tlm
from repro_torch.nn.param import init_params as t_init_params
from repro_torch.nn.param import load_arrays
from repro_torch.serve.engine import GenRequest as TReq
from repro_torch.serve.engine import ServingEngine as TEng
from repro_torch.serve.spec import ServeSpec as TSpec


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _bridge(params_j, specs_t):
    return load_arrays(specs_t, _tree_to_arrays(params_j), device="cpu")


def _tensors(tree):
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in _tree_to_arrays_t(tree).items()}


def _tree_to_arrays_t(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_to_arrays_t(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_int8_specs_halve_weight_bytes():
    """JAX's test, and the port's specs equal to JAX's: the same leaves,
    shapes and dtypes (w_int8 int8, w_scale (1, d_out) float32)."""
    f = tel.EMTConfig(mode="analog")
    q = tel.EMTConfig(mode="analog", store_int8=True)

    def nbytes(specs):
        return sum(int(np.prod(s.shape)) * torch.empty(
            (), dtype=s.dtype).element_size() for s in specs.values())

    sf = tel.dense_specs(256, 512, f, dtype=torch.bfloat16)
    sq = tel.dense_specs(256, 512, q, dtype=torch.bfloat16)
    assert nbytes(sq) < nbytes(sf) * 0.55
    jq = abstract_params(jel.dense_specs(256, 512, jel.EMTConfig(
        mode="analog", store_int8=True), dtype=jnp.bfloat16))
    assert set(jq) == set(sq)
    for k, s in sq.items():
        assert tuple(jq[k].shape) == tuple(s.shape), k
        assert str(jq[k].dtype) == str(s.dtype).replace("torch.", ""), k
    # the port's seeded init: levels in [-127, 127], JAX's constant scale
    p = t_init_params(sq, 0, device="cpu")
    assert p["w_int8"].dtype is torch.int8
    assert int(p["w_int8"].abs().max()) == 127
    assert torch.equal(p["w_scale"], torch.full((1, 512), 1.0 / 127.0))


def test_int8_matches_float_path():
    """JAX's test on both packages: quantize_tree_for_serving bit-equal to
    JAX's, the int8 layer within int8 quantization error of the float one,
    and the port's int8 emt_dense (K3's wrapper on the int8 operand) equal
    to JAX's on the same params and input."""
    cfg_fj = jel.EMTConfig(mode="analog", rho_init=1e6)
    cfg_qj = jel.EMTConfig(mode="analog", rho_init=1e6, store_int8=True)
    cfg_ft = tel.EMTConfig(mode="analog", rho_init=1e6)
    cfg_qt = tel.EMTConfig(mode="analog", rho_init=1e6, store_int8=True)
    params_j = init_params(jel.dense_specs(64, 32, cfg_fj),
                           jax.random.PRNGKey(0))
    params_qj = jel.quantize_tree_for_serving(params_j)
    params_t = _bridge(params_j, tel.dense_specs(64, 32, cfg_ft))
    params_qt = tel.quantize_tree_for_serving(params_t)
    assert params_qt["w_int8"].dtype is torch.int8
    np.testing.assert_array_equal(params_qt["w_int8"].numpy(),
                                  np.asarray(params_qj["w_int8"]))
    np.testing.assert_array_equal(params_qt["w_scale"].numpy(),
                                  np.asarray(params_qj["w_scale"]))
    assert set(params_qt) == set(params_qj)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (8, 64)))
    y_f, _ = tel.emt_dense(params_t, torch.from_numpy(x), cfg_ft, tag="t")
    y_q, aux_t = tel.emt_dense(params_qt, torch.from_numpy(x), cfg_qt,
                               tag="t")
    rel = float(torch.linalg.norm(y_f - y_q) / torch.linalg.norm(y_f))
    assert rel < 0.02, rel          # int8 quantization error only
    y_qj, aux_j = jel.emt_dense(params_qj, jnp.asarray(x), cfg_qj, tag="t",
                                seed=0)
    assert _rel(y_q.numpy(), y_qj) <= 1e-6
    for k in ("energy_pj", "reg", "reads", "rho_sum"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5, err_msg=k)
    assert aux_t["cells"] == aux_j["cells"] == 64 * 32


def test_int8_accounting_reads_the_levels(monkeypatch):
    """On K3's path (analog, hash noise) the int8 layer builds no float32
    weight: the accounting's |w| sum and max come from the levels' int32
    column sums and maxima times the scale.  Its energy and reg equal
    JAX's, which sums the dequantized weight, within rtol 1e-5 at a width
    of gemma3-1b's (1152 x 1024, a million-odd |w| terms); no op of the
    layer outside K3's wrapper (stubbed here: on the CPU its plain version
    dequantizes) returns a weight-sized float tensor."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import ops
    K, N = 1152, 1024
    cfg_j = jel.EMTConfig(mode="analog", rho_init=3.0)
    cfg_t = tel.EMTConfig(mode="analog", rho_init=3.0, store_int8=True)
    params_j = jel.quantize_tree_for_serving(init_params(
        jel.dense_specs(K, N, cfg_j), jax.random.PRNGKey(5)))
    params_t = _bridge(params_j, tel.dense_specs(K, N, cfg_t))
    x = np.array(jax.random.normal(jax.random.PRNGKey(6), (4, K)))
    y_j, aux_j = jel.emt_dense(params_j, jnp.asarray(x), cfg_j, tag="t",
                               seed=2)
    y_t, aux_t = tel.emt_dense(params_t, torch.from_numpy(x), cfg_t,
                               tag="t", seed=2)
    assert _rel(y_t.numpy(), y_j) <= 1e-6
    for k in ("energy_pj", "reg"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5, err_msg=k)

    class Record(TorchDispatchMode):
        big = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (torch.is_tensor(t) and t.is_floating_point()
                        and t.numel() >= K * N):
                    self.big.append(str(func))
            return out

    monkeypatch.setattr(ops, "emt_matmul", lambda x, w, *a, **kw: torch.zeros(
        (*x.shape[:-1], N)))
    with Record():
        _, aux_s = tel.emt_dense(params_t, torch.from_numpy(x), cfg_t,
                                 tag="t", seed=2)
    assert Record.big == []
    assert float(aux_s["energy_pj"]) == float(aux_t["energy_pj"])


@pytest.mark.parametrize("mode", ["analog", "bitserial"])
def test_int8_with_noise_finite(mode):
    """JAX's test on JAX's own int8 init (levels quantized from a float
    init, the scale the constant 1/127): the port's layer on those params
    equals JAX's at sigma > 0, in analog mode (K3's int8 operand) and in
    bit-serial mode (dequantized, then K5's plain version); and the
    draft's digital corner (store_int8 off) takes the int8 form from the
    params alone."""
    cfg_j = jel.EMTConfig(mode=mode, rho_init=2.0, store_int8=True)
    cfg_t = tel.EMTConfig(mode=mode, rho_init=2.0, store_int8=True)
    params_j = init_params(jel.dense_specs(64, 32, cfg_j),
                           jax.random.PRNGKey(0))
    np.testing.assert_array_equal(np.asarray(params_j["w_scale"]),
                                  np.full((1, 32), 1 / 127, np.float32))
    params_t = _bridge(params_j, tel.dense_specs(64, 32, cfg_t))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (8, 64)))
    y_j, aux_j = jel.emt_dense(params_j, jnp.asarray(x), cfg_j, tag="t",
                               seed=3)
    y_t, aux_t = tel.emt_dense(params_t, torch.from_numpy(x), cfg_t,
                               tag="t", seed=3)
    assert bool(torch.isfinite(y_t).all())
    assert aux_t["cells"] == aux_j["cells"] == 64 * 32
    assert _rel(y_t.numpy(), y_j) <= 1e-6
    np.testing.assert_allclose(float(aux_t["energy_pj"]),
                               float(aux_j["energy_pj"]), rtol=1e-5)
    dj = jel.EMTConfig(mode=mode, rho_init=2.0).replace(
        device=jel.DeviceModel(amplitude=0.0))
    dt = tel.EMTConfig(mode=mode, rho_init=2.0).replace(
        device=DeviceModel(amplitude=0.0))
    y_j, _ = jel.emt_dense(params_j, jnp.asarray(x), dj, tag="t", seed=3)
    y_t, _ = tel.emt_dense(params_t, torch.from_numpy(x), dt, tag="t",
                           seed=3)
    assert _rel(y_t.numpy(), y_j) <= 1e-6


def test_quantize_tree_nested():
    """JAX's nested tree: every dict with w and rho_raw converted, others
    kept, bit-equal to JAX's; and a whole smoke model's tree, whose tied
    unembed (no w) stays float."""
    cfg_j = jel.EMTConfig(mode="analog")
    cfg_t = tel.EMTConfig(mode="analog")
    tree_j = {"a": jel.dense_specs(16, 16, cfg_j),
              "b": {"c": jel.dense_specs(16, 8, cfg_j)}}
    tree_t = {"a": tel.dense_specs(16, 16, cfg_t),
              "b": {"c": tel.dense_specs(16, 8, cfg_t)}}
    params_j = init_params(tree_j, jax.random.PRNGKey(0))
    q_j = jel.quantize_tree_for_serving(params_j)
    q_t = tel.quantize_tree_for_serving(_bridge(params_j, tree_t))
    assert "w_int8" in q_t["a"] and "w_int8" in q_t["b"]["c"]
    assert "rho_raw" in q_t["a"]
    flat_j, flat_t = _tree_to_arrays(q_j), _tensors(q_t)
    assert set(flat_j) == set(flat_t)
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_t[k], np.asarray(v), err_msg=k)
        assert flat_t[k].dtype == np.asarray(v).dtype, k


def _smoke():
    kw = dict(arch="gemma3-1b", mode="analog", smoke=True, all_global=True,
              a_per_row=True, model_overrides={"num_layers": 2})
    cfg_j = JSpec(**kw).build_config()
    cfg_t = TSpec(**kw).build_config()
    params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
    params_t = tlm.load_jax_arrays(_tree_to_arrays(params_j), cfg_t,
                                   device="cpu")
    return cfg_j, jel.quantize_tree_for_serving(params_j), cfg_t, params_t


def test_int8_smoke_engine_serves_jax_tokens():
    """The all-global smoke model served on int8 params (the float tree
    quantized): the port's contiguous and paged engines give JAX's tokens
    and ledgers; the int8 tree the port quantizes equals JAX's carried
    through the bridge under the store_int8 config (whose unembed, the
    tied table, stays float)."""
    cfg_j, q_j, cfg_t, params_t = _smoke()
    q_t = tel.quantize_tree_for_serving(params_t)
    cfg_q = cfg_t.replace(emt=cfg_t.emt.replace(store_int8=True))
    bridged = tlm.load_jax_arrays(_tree_to_arrays(q_j), cfg_q, device="cpu")
    flat_b, flat_t = _tensors(bridged), _tensors(q_t)
    assert set(flat_b) == set(flat_t)
    for k, v in flat_b.items():
        np.testing.assert_array_equal(flat_t[k], v, err_msg=k)
    assert "w_int8" in q_t["decoder"]["layer_000"]["attn"]["wq"]
    assert set(q_t["lm_head"]) == {"rho_raw"}
    rng = np.random.default_rng(4)
    specs = [dict(prompt=rng.integers(0, 512, n).astype(np.int32),
                  max_new=6, seed=i) for i, n in enumerate((9, 4, 13))]
    kw = dict(batch_size=2, max_len=32, seed=7, prefill_chunk=8)
    ej = JEng(cfg_j, q_j, fresh_noise=False, **kw)
    rj = ej.serve([JReq(**s) for s in specs], stagger=1)
    for paged in (False, True):
        et = TEng(cfg_q, q_t, fresh_noise=False, paged=paged, block_size=8,
                  device="cpu", **kw)
        rt = et.serve([TReq(**s) for s in specs], stagger=1)
        for a, b in zip(rj, rt):
            np.testing.assert_array_equal(b.tokens, a.tokens)
            np.testing.assert_allclose(b.energy_pj, a.energy_pj, rtol=1e-5)
        np.testing.assert_allclose(et.total_energy_pj, ej.total_energy_pj,
                                   rtol=1e-5)
        assert et.energy_conserved(rt)


def test_int8_operand_is_serve_only():
    """On the CPU the int8 operand is its plain version (dequantize, then
    K3's plain path); a gradient through it raises."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 24), generator=g)
    q = torch.randint(-127, 128, (24, 10), generator=g, dtype=torch.int8)
    scale = torch.rand((1, 10), generator=g) / 127
    sig = torch.tensor(0.05)
    kw = dict(device=DeviceModel(), seed=4, plane=9)
    y = k3.emt_matmul(x, (q, scale), sig, **kw)
    assert torch.equal(y, k3.plain(x, dequantize(q, scale), sig, **kw))
    xr = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="serve-only"):
        k3.emt_matmul(xr, (q, scale), sig, **kw).sum().backward()


# (M, K, N, transposed): every GEMV row template (1-4, 8, 16), the tiled
# kernel (M > 16: the verify chunk's M = 20 among them), both layouts,
# ragged N and K (the byte loads), most cases split along K.
K3_INT8_CASES = [(4, 96, 200, False), (4, 1152, 1024, False),
                 (20, 1152, 256, False), (64, 256, 130, False),
                 (3, 64, 300, True), (1, 1000, 262, False),
                 (2, 555, 1001, False), (6, 4100, 64, True),
                 (16, 777, 514, False), (16, 300, 208, True),
                 (17, 1000, 130, False), (64, 1000, 320, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,transposed", K3_INT8_CASES)
@pytest.mark.parametrize("dev", [DeviceModel(), four_state_device()],
                         ids=["two", "four"])
def test_k3_int8_matches_plain_and_noise_bit_exact(M, K, N, transposed, dev):
    """The int8 kernel within 1e-5 of its plain version, counted on
    ``_forward_int8.launches``; two calls bit-identical; I gives the
    noisy dequantized weight bit for bit (fluctuate of fl(q * scale))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from repro_torch.core import noise
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=cuda)
    q = torch.randint(-127, 128, (N, K) if transposed else (K, N),
                      generator=g, device=cuda, dtype=torch.int8)
    q = q.T if transposed else q
    scale = torch.rand((1, N), generator=g, device=cuda) / 100
    rho = torch.tensor(3.5, device=cuda)
    sig = dev.sigma_rel(rho)
    kw = dict(device=dev, seed=99, plane=1234)
    before = (k3._forward_int8.launches, k3.emt_matmul.launches)
    y = k3.emt_matmul(x, (q, scale), sig, **kw)
    assert (k3._forward_int8.launches, k3.emt_matmul.launches) == (
        before[0] + 1, before[1])
    p = k3.plan(M, N, K, torch.cuda.get_device_properties(cuda)
                .multi_processor_count, not transposed)
    assert _rel(y.cpu(), k3.plain(x, (q, scale), sig, **kw).cpu()) <= 1e-5, p
    assert torch.equal(y, k3.emt_matmul(x, (q, scale), sig, **kw)), p
    ref = noise.fluctuate(dequantize(q, scale), rho, dev,
                          noise.NoiseConfig(), seed=99, plane=1234)
    rows = torch.randperm(K, generator=g, device=cuda)[:M]
    eye = torch.eye(K, device=cuda)
    assert torch.equal(k3.emt_matmul(eye[rows], (q, scale), sig, **kw),
                       ref[rows]), p
    assert torch.equal(k3.emt_matmul(eye, (q, scale), sig, **kw), ref), p
