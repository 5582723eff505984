"""Port parity of the training gradients against ``jax.value_and_grad`` /
``jax.vjp`` of the JAX package, on seeded numpy inputs (weights carried
across by the bridge).

* K3's module (``kernels/emt_matmul.py``): the differentiable noisy
  matmul's dx, dw and drho against the VJP XLA gives ``x @ fluctuate(w)``;
* K5's module (``kernels/emt_bitserial.py``) and ``decompose``: the
  ideal-matmul VJP (JAX's ``decompose._bwd``);
* ``emt_dense`` analog and bit-serial, per-tensor and per-row DAC, on a
  plain weight and on the tied unembed's strided ``table.T``: dx, dw (or
  dtable) and drho_raw.  The bit-serial dx was 0 before the ideal-matmul
  VJP was ported (autograd through the bit planes' floor/sign);
* ``lm.train_loss`` on gemma3-1b smoke at 2 layers, all-global, on the
  ring stack (two sliding-window layers, window 8 < S = 16) and on the
  mixed placement: the loss and every gradient leaf.

Tolerances (float32; XLA and torch sum in other orders): a layer's or a
product's gradient within 2e-5 of the largest |value| of that tensor (a
few float32 ulps of the largest term of a K-long sum); a scalar drho
within 1e-5 of the sum of |terms| it adds; the model's loss within 1e-6
relative and each gradient leaf within 1e-5 of its largest |value| (two
layers of float32 order differences: 1.2e-6 at most measured).  Technique
B's term differentiates |w| as JAX does, +1 at w = 0
(``regularizer.jax_abs``); torch.abs's 0 there moved dw by up to 5%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.configs import get_config as j_get_config
from repro.configs.common import emt_preset as j_emt_preset
from repro.core import decompose as jdec
from repro.core import emt_linear as jel
from repro.core import noise as jnoise
from repro.core.device import DeviceModel as JDevice
from repro.core.quant import QuantConfig as JQC
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro.nn.param import init_params
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.common import emt_preset as t_emt_preset
from repro_torch.core import decompose as tdec
from repro_torch.core import emt_linear as tel
from repro_torch.core.device import DeviceModel as TDevice
from repro_torch.core.quant import QuantConfig as TQC
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import emt_bitserial as k5
from repro_torch.kernels import emt_matmul as k3
from repro_torch.models import lm as tlm
from repro_torch.train.step import make_grad_fn
from repro_torch.utils.pytrees import flatten_with_paths

SEED, PLANE = 7, 4321


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a, grad=True):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


def _close(a, b, tol, what=""):
    """max |a - b| <= tol * max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b).max()
    assert d <= tol * max(np.abs(b).max(), 1e-30), (what, d, np.abs(b).max())


def test_k3_vjp_matches_xla_vjp_of_fluctuate():
    """dx, dw and drho of x @ noisy(w) (K3's wrapper, its plain backward
    on the CPU) against jax.vjp of x @ fluctuate(w, rho); also on a
    transposed weight, whose noise hashes the logical (k, n)."""
    rng = np.random.default_rng(0)
    dev_j, dev_t = JDevice(), TDevice()
    for transposed in (False, True):
        x, g = _np(rng, 6, 40), _np(rng, 6, 24)
        w = _np(rng, 24, 40).T if transposed else _np(rng, 40, 24)
        rho = np.float32(3.3)

        def f(x, w, rho):
            return x @ jnoise.fluctuate(w, rho, dev_j, jnoise.NoiseConfig(),
                                        seed=SEED, plane=PLANE)
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(rho))
        jdx, jdw, jdrho = vjp(jnp.asarray(g))
        xt, rt = _t(x), _t(rho)
        wt = (_t(np.ascontiguousarray(w.T)).T if transposed else _t(w))
        y = k3.emt_matmul(xt, wt, dev_t.sigma_rel(rt), device=dev_t,
                          seed=SEED, plane=PLANE)
        dx, dw, drho = torch.autograd.grad((y * torch.tensor(g)).sum(),
                                           [xt, wt, rt])
        _close(dx, jdx, 2e-5, "dx")
        _close(dw, jdw, 2e-5, "dw")
        terms = np.abs(np.asarray(x).T @ g).sum() * np.abs(w).max()
        assert abs(drho.item() - float(jdrho)) <= 1e-5 * terms


def test_k3_plain_backward_is_the_materialized_factor():
    """On the CPU the wrappers take the plain backward: dw is (x^T g) * f
    exactly, dsigma the sum of (x^T g) * w * a, dx g @ (w f)^T."""
    from repro_torch.core import hashrng
    from repro_torch.core.noise import noise_factor
    rng = np.random.default_rng(1)
    dev = TDevice()
    x, g, w = (torch.tensor(_np(rng, 5, 30)), torch.tensor(_np(rng, 5, 12)),
               torch.tensor(_np(rng, 30, 12)))
    sig = dev.sigma_rel(torch.tensor(2.0))
    a = hashrng.tile_state_offsets(SEED, 0, 0, (30, 12), dev.state_offsets,
                                   dev.state_probs, PLANE)
    f = noise_factor(a, sig)
    kw = dict(device=dev, seed=SEED, plane=PLANE)
    before = (k3.emt_matmul_dx.launches, k3.emt_matmul_dw.launches)
    dw, dsig = k3.emt_matmul_dw(x, g, w, sig, **kw)
    assert torch.equal(dw, (x.T @ g) * f)
    assert torch.equal(dsig, torch.sum(((x.T @ g) * w) * a))
    assert torch.equal(k3.emt_matmul_dx(g, w, sig, **kw), g @ (w * f).T)
    # the plain versions launch nothing
    assert before == (k3.emt_matmul_dx.launches, k3.emt_matmul_dw.launches)


def test_bitserial_ideal_vjp_matches_jax():
    """K5's wrapper and decompose.bitserial_matmul_ref take JAX's
    ideal-matmul VJP: gx = g @ w^T, gw = xq^T g, zero for rho."""
    rng = np.random.default_rng(2)
    xq = np.clip(np.round(_np(rng, 3, 5, 20, scale=40)), -127, 127)
    w, g = _np(rng, 20, 9), _np(rng, 3, 5, 9)
    rho = np.float32(4.0)
    dev_j, dev_t = JDevice(), TDevice()

    def f(xq, w, rho):
        return jdec.bitserial_matmul_ref(xq, w, rho, dev_j, 7, seed=SEED,
                                         base_plane=PLANE)
    _, vjp = jax.vjp(f, jnp.asarray(xq), jnp.asarray(w), jnp.asarray(rho))
    jgx, jgw, jgr = vjp(jnp.asarray(g))
    assert float(jgr) == 0.0
    for via_kernel in (True, False):
        xt, wt, rt = _t(xq), _t(w), _t(rho)
        if via_kernel:
            y = k5.emt_bitserial(xt.reshape(-1, 20), wt, dev_t.sigma_rel(rt),
                                 device=dev_t, seed=SEED, base_plane=PLANE)
            y = y.reshape(3, 5, 9)
        else:
            y = tdec.bitserial_matmul_ref(xt, wt, rt, dev_t, 7, seed=SEED,
                                          base_plane=PLANE)
        gx, gw, gr = torch.autograd.grad((y * torch.tensor(g)).sum(),
                                         [xt, wt, rt])
        _close(gx, jgx, 2e-5, "gx")
        _close(gw, jgw, 2e-5, "gw")
        assert gr.item() == 0.0


@pytest.mark.parametrize("mode", ["analog", "bitserial"])
@pytest.mark.parametrize("a_per_row", [False, True])
@pytest.mark.parametrize("tied", [False, True], ids=["w", "table.T"])
def test_emt_dense_gradients_match_jax(mode, a_per_row, tied):
    """dx, dw (dtable for the tied unembed's table.T) and drho_raw of one
    emt_dense (16 -> 8, 4 rows) under a random cotangent."""
    rng = np.random.default_rng(3)
    x = _np(rng, 4, 16)
    wmat = _np(rng, 8, 16, scale=0.3) if tied else _np(rng, 16, 8, scale=0.3)
    c = _np(rng, 4, 8)
    jc = j_emt_preset(mode).replace(quant=JQC(a_per_row=a_per_row))
    tc = t_emt_preset(mode).replace(quant=TQC(a_per_row=a_per_row))
    raw = np.float32(jel.regularizer.rho_init_raw(4.0))

    def jloss(wmat, rho_raw, x):
        p = {"w": wmat.T if tied else wmat, "rho_raw": rho_raw}
        y, _ = jel.emt_dense(p, x, jc, tag="unembed", seed=SEED)
        return jnp.sum(y * c)
    jdw, jdr, jdx = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(wmat), jnp.asarray(raw), jnp.asarray(x))
    wt, rt, xt = _t(wmat), _t(raw), _t(x)
    y, _ = tel.emt_dense({"w": wt.T if tied else wt, "rho_raw": rt}, xt, tc,
                         tag="unembed", seed=SEED)
    dw, dr, dx = torch.autograd.grad((y * torch.tensor(c)).sum(),
                                     [wt, rt, xt])
    assert np.abs(np.asarray(jdx)).max() > 0
    assert dx.abs().max() > 0              # bit-serial: 0 before the VJP
    _close(dx, jdx, 2e-5, "dx")
    _close(dw, jdw, 2e-5, "dw")
    terms = np.abs(np.asarray(jdw)).sum() * np.abs(wmat).max()
    assert abs(dr.item() - float(jdr)) <= 1e-5 * max(terms, 1e-30)
    if mode == "bitserial":
        # rho's only gradient is technique B's term, none here
        assert dr.item() == 0.0 and float(jdr) == 0.0


def _lm_cfgs(stack: str):
    kw = dict(placement="mixed") if stack == "mixed" else {}
    cj = j_get_config("gemma3-1b", smoke=True, **kw).replace(num_layers=2)
    ct = t_get_config("gemma3-1b", smoke=True, **kw).replace(num_layers=2)
    if stack == "global":
        cj = cj.replace(layer_pattern=("global",))
        ct = ct.replace(layer_pattern=("global",))
    return cj, ct


@pytest.mark.parametrize("stack", ["global", "ring", "mixed"])
def test_train_loss_and_every_gradient_match_jax(stack):
    cj, ct = _lm_cfgs(stack)
    assert ct.blocks() == cj.blocks()
    if stack == "ring":
        assert ct.blocks() == ("local", "local") and ct.sliding_window == 8
    params_j = init_params(jlm.specs(cj), jax.random.PRNGKey(0))
    arrays = _tree_to_arrays(params_j)
    params_t = tlm.load_jax_arrays(arrays, ct, device="cpu")
    for _, p in flatten_with_paths(params_t):
        p.requires_grad_(True)
    batch = SyntheticLM(ct.vocab_size, 16, 2, device="cpu").arrays_at(3)
    lam = 1e-3
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b, s: jlm.train_loss(p, b, cj, JCtx(seed=s), lam=lam),
        has_aux=True))
    (jloss, jm), jgrads = jgrad(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.uint32(3))
    loss, metrics, grads = make_grad_fn(ct, lam)(
        params_t, {k: torch.from_numpy(v) for k, v in batch.items()}, 3)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for k in ("ce", "reg", "energy_uj", "rho_mean"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    corners = sorted(k for k in jm if k.startswith("energy_uj/"))
    assert corners == sorted(k for k in metrics
                             if k.startswith("energy_uj/"))
    jflat = dict(_tree_to_arrays(jgrads))
    tflat = flatten_with_paths(grads)
    assert sorted(jflat) == [p for p, _ in tflat]
    for path, g in tflat:
        assert torch.isfinite(g).all(), path
        _close(g.numpy(), jflat[path], 1e-5, path)
    rho_leaves = [p for p in jflat if p.endswith("rho_raw")]
    assert rho_leaves and all(np.abs(jflat[p]).max() > 0 for p in rho_leaves)
