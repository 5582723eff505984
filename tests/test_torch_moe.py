"""Port parity of the mixture-of-experts layer (``repro_torch.models.moe``)
against ``repro.models.moe`` on identical weights (numpy bridge) and the
same seeded inputs: the five cases of tests/test_moe.py, run on both
packages, then outputs and aux of ``moe_ffn`` on the IDEAL, analog and
"mixed" corners, a capacity overflow (the same (token, expert) pairs kept
as JAX's), a tied router (JAX's expert order: the lowest index first), and
the plain version of K3's experts entry against ``fluctuate`` of the
folded stack.

Tolerances: layer outputs fp32 (atol 1e-5 on O(1) values); aux_loss rtol
1e-6; energy ledgers rtol 1e-5 (float32 sums of weight-sized reductions
in another order); the noisy stack bit-exact (hash noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.configs.common import emt_preset as j_preset
from repro.configs.common import mixed_placement as j_mixed
from repro.core import noise as jnoise
from repro.core.emt_linear import IDEAL as J_IDEAL
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro.models.context import Ctx as JCtx
from repro.nn.param import init_params
from repro_torch.configs.common import emt_preset as t_preset
from repro_torch.configs.common import mixed_placement as t_mixed
from repro_torch.core import noise as tnoise
from repro_torch.core import regularizer
from repro_torch.core.device import DeviceModel, four_state_device
from repro_torch.core.emt_linear import IDEAL as T_IDEAL
from repro_torch.kernels import emt_matmul as k3
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.context import Ctx as TCtx
from repro_torch.nn.param import load_arrays

TAG = "dec/layer_000/moe"
EMTS = {"ideal": (J_IDEAL, T_IDEAL),
        "analog": (j_preset("analog"), t_preset("analog")),
        "mixed": (j_mixed(), t_mixed())}


def _cfgs(emt="ideal", **kw):
    """The JAX test file's config, for both packages."""
    base = dict(name="t", family="moe", num_layers=1, d_model=32,
                num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
                head_dim=16, num_experts=4, experts_per_token=2, moe_d_ff=64)
    base.update(kw)
    je, te = EMTS[emt]
    return (JConfig(dtype=jnp.float32, emt=je, **base),
            TConfig(dtype=torch.float32, emt=te, **base))


def _params(jc, tc, seed=0):
    pj = init_params(jmoe.moe_specs(jc, TAG), jax.random.PRNGKey(seed))
    pt = load_arrays(tmoe.moe_specs(tc, TAG), _tree_to_arrays(pj),
                     device="cpu")
    return pj, pt


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(jc, tc, pj, pt, x, seed=3):
    yj, aj = jmoe.moe_ffn(pj, jnp.asarray(x), jc,
                          ctx=JCtx(seed=jnp.uint32(seed)), tag=TAG)
    yt, at = tmoe.moe_ffn(pt, torch.from_numpy(x), tc, ctx=TCtx(seed=seed),
                          tag=TAG)
    return (np.asarray(yj), aj), (yt.detach().numpy(), at)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


# --- the five cases of tests/test_moe.py, on both packages ----------------
def test_moe_forward_finite_and_shaped():
    jc, tc = _cfgs()
    pj, pt = _params(jc, tc)
    x = _x((2, 16, 32))
    (yj, aj), (yt, at) = _both(jc, tc, pj, pt, x)
    assert yt.shape == x.shape and np.isfinite(yt).all()
    assert float(at["aux_loss"]) > 0
    _close(yt, yj)
    np.testing.assert_allclose(float(at["aux_loss"]), float(aj["aux_loss"]),
                               rtol=1e-6)


def test_single_expert_topk1_equals_dense_mlp():
    """E = 1, k = 1, capacity >= tokens: the layer is its expert's MLP, on
    both packages."""
    jc, tc = _cfgs(num_experts=1, experts_per_token=1, capacity_factor=64.0)
    pj, pt = _params(jc, tc)
    x = _x((1, 16, 32))
    (yj, _), (yt, _) = _both(jc, tc, pj, pt, x)
    xt = torch.from_numpy(x)
    ref = (torch.nn.functional.silu(xt @ pt["wg"][0]) * (xt @ pt["wu"][0])
           ) @ pt["wd"][0]
    np.testing.assert_allclose(yt, ref.numpy(), rtol=2e-4, atol=2e-4)
    _close(yt, yj)


def test_capacity_drops_tokens():
    """A tiny capacity factor drops tokens: the output shrinks, and both
    packages give the same outputs at either capacity."""
    x = _x((2, 64, 32))
    jb, tb = _cfgs(capacity_factor=8.0)
    js, ts = jb.replace(capacity_factor=0.05), tb.replace(capacity_factor=0.05)
    pj, pt = _params(jb, tb)
    (yjb, _), (ytb, _) = _both(jb, tb, pj, pt, x)
    (yjs, _), (yts, _) = _both(js, ts, pj, pt, x)
    assert np.linalg.norm(yts) < np.linalg.norm(ytb) * 0.7
    _close(ytb, yjb)
    _close(yts, yjs)


def test_router_gradients_flow():
    """The port's CPU path is differentiable: gradients reach the router
    and the expert stacks, equal to jax.grad's (fp32 tolerance)."""
    jc, tc = _cfgs()
    pj, pt = _params(jc, tc)
    x = _x((1, 32, 32))

    def jloss(p):
        y, aux = jmoe.moe_ffn(p, jnp.asarray(x), jc, ctx=JCtx(), tag=TAG)
        return jnp.mean(y ** 2) + aux["aux_loss"]

    gj = jax.grad(jloss)(pj)
    leaves = {"router": pt["router"]["w"], "wg": pt["wg"], "wu": pt["wu"],
              "wd": pt["wd"]}
    for t in leaves.values():
        t.requires_grad_(True)
    y, aux = tmoe.moe_ffn(pt, torch.from_numpy(x), tc, ctx=TCtx(), tag=TAG)
    (torch.mean(y ** 2) + aux["aux_loss"]).backward()
    assert float(leaves["router"].grad.norm()) > 0
    assert float(leaves["wg"].grad.norm()) > 0
    want = {"router": gj["router"]["w"], "wg": gj["wg"], "wu": gj["wu"],
            "wd": gj["wd"]}
    for name, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_emt_moe_energy_accounting():
    jc, tc = _cfgs("analog")
    pj, pt = _params(jc, tc)
    x = _x((1, 32, 32))
    (yj, aj), (yt, at) = _both(jc, tc, pj, pt, x)
    assert float(at["energy_pj"]) > 0
    assert at["cells"] == aj["cells"] == 3 * 4 * 32 * 64
    assert np.isfinite(yt).all()
    np.testing.assert_allclose(float(at["energy_pj"]),
                               float(aj["energy_pj"]), rtol=1e-5)


# --- outputs and aux on every corner ----------------------------------------
@pytest.mark.parametrize("emt", sorted(EMTS))
def test_moe_ffn_outputs_and_aux_match_jax(emt):
    """y to fp32 tolerance, aux_loss to rtol 1e-6, and the ledger (energy,
    reads, cells, reg, rho, every corner) to rtol 1e-5, on a (4, 16) input
    (64 tokens, capacity 40 a queue)."""
    jc, tc = _cfgs(emt)
    pj, pt = _params(jc, tc, seed=2)
    x = _x((4, 16, 32), seed=5)
    (yj, aj), (yt, at) = _both(jc, tc, pj, pt, x, seed=11)
    _close(yt, yj)
    np.testing.assert_allclose(float(at["aux_loss"]), float(aj["aux_loss"]),
                               rtol=1e-6)
    for key in ("energy_pj", "reads", "reg", "rho_sum"):
        np.testing.assert_allclose(float(at[key]), float(aj[key]), rtol=1e-5,
                                   err_msg=key)
    assert at["cells"] == aj["cells"]
    assert at["rho_layers"] == aj["rho_layers"]
    assert set(at["corners"]) == set(aj["corners"])
    for name, c in aj["corners"].items():
        np.testing.assert_allclose(float(at["corners"][name]["energy_pj"]),
                                   float(c["energy_pj"]), rtol=1e-5,
                                   err_msg=name)


def _dispatch(monkeypatch, run, mod, attr):
    """Run `run()` and return the arguments of its dispatch einsum
    ("gske,gskec->gsec": the (token, k, expert) one-hot and the kept slot
    one-hot) as numpy arrays."""
    orig = getattr(mod, attr)
    seen = []

    def spy(eq, *ops_):
        if eq == "gske,gskec->gsec":
            seen.append([np.asarray(o) for o in ops_])
        return orig(eq, *ops_)

    monkeypatch.setattr(mod, attr, spy)
    run()
    monkeypatch.setattr(mod, attr, orig)
    assert len(seen) == 1
    return seen[0]


def test_capacity_overflow_keeps_jax_tokens(monkeypatch):
    """Capacity 4 for 64 tokens at top-2 of 4 experts: most (token, expert)
    pairs are dropped; the kept pairs, their queue slots and the outputs
    equal JAX's."""
    jc, tc = _cfgs(capacity_factor=0.1)
    pj, pt = _params(jc, tc, seed=4)
    x = _x((2, 32, 32), seed=6)
    runs = {}
    dj = _dispatch(monkeypatch, lambda: runs.setdefault(
        "j", jmoe.moe_ffn(pj, jnp.asarray(x), jc, ctx=JCtx(), tag=TAG)),
        jnp, "einsum")
    dt = _dispatch(monkeypatch, lambda: runs.setdefault(
        "t", tmoe.moe_ffn(pt, torch.from_numpy(x), tc, ctx=TCtx(), tag=TAG)),
        torch, "einsum")
    np.testing.assert_array_equal(dt[0], dj[0])          # routing
    np.testing.assert_array_equal(dt[1], dj[1])          # kept slots
    kept = dt[1].sum(-1) > 0                              # (G, s, K, E)
    assert 0 < kept.sum() < dt[0].sum()                   # some dropped
    _close(runs["t"][0].detach().numpy(), np.asarray(runs["j"][0]))


def test_tied_router_takes_jax_expert_order(monkeypatch):
    """A zero input gives every expert the same probability: JAX's top_k
    takes the lowest indices first, and so does the port (a stable
    descending sort), whose queues and outputs then equal JAX's."""
    jc, tc = _cfgs(num_experts=4, experts_per_token=3)
    pj, pt = _params(jc, tc)
    x = np.zeros((2, 8, 32), np.float32)
    runs = {}
    dj = _dispatch(monkeypatch, lambda: runs.setdefault(
        "j", jmoe.moe_ffn(pj, jnp.asarray(x), jc, ctx=JCtx(), tag=TAG)),
        jnp, "einsum")
    dt = _dispatch(monkeypatch, lambda: runs.setdefault(
        "t", tmoe.moe_ffn(pt, torch.from_numpy(x), tc, ctx=TCtx(), tag=TAG)),
        torch, "einsum")
    experts = dt[0].argmax(-1)                            # (G, s, K)
    assert (experts == np.arange(3)).all()
    np.testing.assert_array_equal(dt[0], dj[0])
    np.testing.assert_array_equal(dt[1], dj[1])
    _close(runs["t"][0].detach().numpy(), np.asarray(runs["j"][0]))


# --- the plain version of K3's experts entry --------------------------------
@pytest.mark.parametrize("dev", [DeviceModel(), four_state_device()],
                         ids=["two", "four"])
def test_experts_ref_is_fluctuate_of_the_folded_stack(dev):
    """x = I per expert returns the noisy stack bit for bit: ``fluctuate``
    of the folded (E * K, N) stack on both packages (expert e's rows hash
    at e * K + k); the statistics are the noisy stack's sum and max of
    |w~| (exact here, JAX's within float32 summation order); a product on
    random inputs equals bmm on that stack within float32 summation order
    (bit for bit would hold BLAS to one order of sums across shapes,
    which it does not promise)."""
    E, K, N = 3, 40, 24
    rng = np.random.default_rng(0)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    rho = torch.tensor(2.5)
    sig = dev.sigma_rel(rho)
    cfg = tnoise.NoiseConfig()
    wt = torch.from_numpy(w)
    eye = torch.eye(K).expand(E, K, K).contiguous()
    y, s, m = k3.plain_experts(eye, wt, sig, device=dev, seed=9, plane=77)
    folded = tnoise.fluctuate(wt.reshape(E * K, N), rho, dev, cfg, seed=9,
                              plane=77).reshape(E, K, N)
    assert torch.equal(y, folded)
    from repro.core.device import DeviceModel as JDevice
    from repro.core.device import four_state_device as j_four
    jdev = JDevice() if len(dev.state_probs) == 2 else j_four()
    fj = np.asarray(jnoise.fluctuate(
        jnp.asarray(w.reshape(E * K, N)), jnp.float32(2.5), jdev,
        jnoise.NoiseConfig(), seed=9, plane=77)).reshape(E, K, N)
    np.testing.assert_array_equal(y.numpy(), fj)
    assert float(s) == float(torch.sum(torch.abs(folded)))
    assert float(m) == float(torch.amax(torch.abs(folded)))
    np.testing.assert_allclose(float(s), float(np.sum(np.abs(fj))),
                               rtol=1e-6)
    assert float(m) == float(np.max(np.abs(fj)))
    x = torch.from_numpy(rng.standard_normal((E, 5, K)).astype(np.float32))
    y2, s2, m2 = ops.emt_matmul_experts(x, wt, sig, device=dev, seed=9,
                                        plane=77)
    # on random rows within float32 summation order (BLAS sums a bmm and
    # a matmul in different orders)
    np.testing.assert_allclose(y2.numpy(), torch.bmm(x, folded).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert float(s2) == float(s) and float(m2) == float(m)
    # expert 0 of the stack is plain K3 on its weight (row base 0): bit
    # for bit on x = I, within summation order on random rows
    assert torch.equal(k3.plain(eye[0], wt[0], sig, device=dev, seed=9,
                                plane=77), folded[0])
    y0 = k3.plain(x[0], wt[0], sig, device=dev, seed=9, plane=77)
    np.testing.assert_allclose(y2[0].numpy(), y0.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_experts_ref_is_differentiable_on_the_cpu():
    """The plain version carries gradients to x, w and sigma (the CPU
    training path), the sum's with JAX's |.| derivative."""
    dev = DeviceModel()
    x = torch.randn(2, 3, 8, requires_grad=True)
    w = torch.randn(2, 8, 5, requires_grad=True)
    rho = torch.tensor(3.0, requires_grad=True)
    y, s, m = ops.emt_matmul_experts(x, w, dev.sigma_rel(rho), device=dev,
                                     seed=1, plane=2)
    (y.sum() + s).backward()
    assert x.grad is not None and w.grad is not None and rho.grad is not None
    assert not m.requires_grad
    wn = tnoise.fluctuate(w.detach().reshape(16, 5), rho.detach(), dev,
                          tnoise.NoiseConfig(), seed=1, plane=2)
    assert float(s.detach()) == float(torch.sum(regularizer.jax_abs(wn)))


def test_expert_plan_counts_every_experts_tiles():
    """K3's planner counts the E experts' tiles before it splits K: at
    moonshot's decode shape one expert alone would split K 22 ways, the
    stack of 64 only as far as the GEMV's staged x rows force (2 slabs of
    1,024 rows at M = 4); at a chunk step's 20 rows the 64 experts'
    256-column tiles of the tensor-core kernel fill the card unsplit."""
    one = k3.plan(4, 1408, 2048, 132, True)
    stack = k3.plan(4, 1408, 2048, 132, True, experts=64)
    assert one.splits == 22 and one.E == 1
    assert (stack.splits, stack.k_slab, stack.E) == (2, 1024, 64)
    assert stack.ctas == 11 * 64 * 2
    chunk = k3.plan(20, 2048, 1408, 132, True, experts=64)
    assert chunk.splits == 1 and chunk.ctas == 8 * 64


def test_int8_serving_tree_leaves_the_expert_stacks_float():
    """quantize_tree_for_serving on the moonshot smoke tree (mixed
    placement): the placed routers and the attention become int8 levels
    and scales equal to JAX's, the expert stacks (a dict with rho_raw but
    no ``w``) stay float, as JAX leaves them; the int8 layer serves."""
    from repro.configs import get_config as j_get
    from repro.core.emt_linear import quantize_tree_for_serving as j_q
    from repro.models import lm as jlm
    from repro_torch.configs import get_config as t_get
    from repro_torch.core.emt_linear import quantize_tree_for_serving as t_q
    from repro_torch.models import lm as tlm
    jc = j_get("moonshot-v1-16b-a3b", smoke=True, placement="mixed").replace(
        dtype=jnp.float32)
    tc = t_get("moonshot-v1-16b-a3b", smoke=True, placement="mixed").replace(
        dtype=torch.float32)
    pj = init_params(jlm.specs(jc), jax.random.PRNGKey(0))
    pt = tlm.load_jax_arrays(_tree_to_arrays(pj), tc, device="cpu")
    qj, qt = _tree_to_arrays(j_q(pj)), t_q(pt)
    flat = {}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v
    walk(qt)
    assert set(flat) == set(qj)
    for path, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(qj[path]),
                                      err_msg=path)
    ffn = qt["decoder"]["layer_000"]["ffn"]
    assert {"w_int8", "w_scale", "rho_raw"} == set(ffn["router"])
    for name in ("wg", "wu", "wd"):
        assert ffn[name].dtype is torch.float32
    h = torch.from_numpy(_x((1, 4, 64)))
    y, aux = tmoe.moe_ffn(ffn, h, tc, ctx=TCtx(seed=1),
                          tag="dec/layer_000/moe")
    assert y.shape == h.shape and torch.isfinite(y).all()
    assert float(aux["energy_pj"]) > 0
