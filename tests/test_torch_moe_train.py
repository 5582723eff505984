"""Port parity of mixture-of-experts training against the JAX package, on
the CPU (the plain versions; the CUDA kernels are held to the same plain
versions on the card by tests/test_torch_gpu.py and chip_smoke.py).

* The experts entry's backward (``kernels/emt_matmul.py``: the plain
  ``emt_matmul_experts_dx_ref`` / ``_dw_ref`` and the autograd Function
  ``plain_experts_differentiable`` built on them): dx, dw with the
  cotangent gs of the noisy stack's sum |w~| (technique B's term), and
  dsigma, against torch's autograd through ``emt_matmul_experts_ref`` and
  against ``jax.vjp`` of JAX's ``fluctuate`` of the folded (E * K, N)
  stack + ``einsum`` + ``layer_reg_term`` (``repro/models/moe.py``
  ``_emt_stacked`` and its accounting), at M <= 16 and M > 16, with exact
  zeros in w (sgn(w~) is +1 there, as JAX's |.|) and the plain noise cut
  into slabs whose edges do not fall on the experts' row bases.
* moonshot-v1-16b-a3b's smoke stack on the mixed placement: the loss and
  every gradient leaf of a training step against ``jax.value_and_grad``
  of JAX's ``lm.train_loss`` on the same seeded weights.
* The training launcher: ``--arch moonshot-v1-16b-a3b --smoke --placement
  mixed``, two steps on the CPU.

Tolerances (float32; XLA and torch sum in other orders): on integer x, g
and gs, dw bit for bit (x^T g + gs exact, then one rounding by the same
factor); otherwise each tensor within 1e-6 of its largest |value| against
torch's autograd and JAX's vjp (one or two float32 ulps of the largest
term of a short sum), dsigma and drho within 1e-6 of the sum of |terms|
they add; the model's loss within 1e-6 relative and each gradient leaf
within 1e-5 of its largest |value| (two layers' float32 order
differences, as tests/test_torch_train_grad.py holds gemma3-1b).
"""
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import shared_weights
from repro.ckpt.checkpoint import _tree_to_arrays
from repro.configs import get_config as j_get_config
from repro.core import noise as jnoise
from repro.core import regularizer as jreg
from repro.core.device import DeviceModel as JDevice
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.device import DeviceModel as TDevice
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import emt_matmul as k3
from repro_torch.kernels import ref
from repro_torch.train.step import make_grad_fn
from repro_torch.utils.pytrees import flatten_with_paths

SEED, PLANE = 11, 2024
MOE = "moonshot-v1-16b-a3b"


def _close(a, b, tol, what=""):
    """max |a - b| <= tol * max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b).max()
    assert d <= tol * max(np.abs(b).max(), 1e-30), (what, d, np.abs(b).max())


def _inputs(E, M, K, N, integer, seed=0):
    """x (E, M, K), w (E, K, N) with exact zeros, g (E, M, N) and the
    cotangent of the reg term: integers for `integer` (x, g and, through
    gr, gs exact)."""
    rng = np.random.default_rng(seed + E + M + K + N)
    if integer:
        x = rng.integers(-4, 5, (E, M, K)).astype(np.float32)
        g = rng.integers(-4, 5, (E, M, N)).astype(np.float32)
    else:
        x = rng.normal(size=(E, M, K)).astype(np.float32)
        g = rng.normal(size=(E, M, N)).astype(np.float32)
    w = (rng.normal(size=(E, K, N)) * 0.3).astype(np.float32)
    w[:, ::3, ::5] = 0.0
    return x, w, g


def _jax_vjp(x, w, g, rho, gs):
    """jax.vjp of (x @ fluctuate(folded w), sum |w~|) at cotangents (g,
    gs), as JAX's MoE layer draws and accounts its noisy stack: dx, dw,
    drho."""
    E, K, N = w.shape
    dev = JDevice()

    def f(x, w, rho):
        wn = jnoise.fluctuate(w.reshape(E * K, N), rho, dev,
                              jnoise.NoiseConfig(), seed=SEED,
                              plane=PLANE).reshape(E, K, N)
        y = jnp.einsum("emk,ekn->emn", x, wn)
        return y, jreg.layer_reg_term(wn, jnp.float32(1.0), alpha=1.0)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(rho))
    return vjp((jnp.asarray(g), jnp.float32(gs)))


# (E, M, K, N): M <= 16 (a moonshot decode step's 4 rows) and M > 16 (a
# chunk's 20); K not a multiple of the slab's rows
EXPERT_CASES = [(3, 4, 10, 12), (4, 20, 13, 7), (2, 1, 30, 5)]


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
@pytest.mark.parametrize("E,M,K,N", EXPERT_CASES)
def test_experts_backward_matches_autograd_and_jax(monkeypatch, E, M, K, N,
                                                   integer):
    """The plain experts dx and dw (with gs) and dsigma against torch's
    autograd through the plain forward and against jax.vjp; the plain
    noise cut into slabs of 50 elements, whose edges fall inside experts
    (the row bases e * K hash the same bits)."""
    monkeypatch.setattr(ref, "NOISE_SLAB", 50)
    x, w, g = _inputs(E, M, K, N, integer)
    gs = 3.0 if integer else 0.37
    dev = TDevice()
    rho = np.float32(3.3)
    kw = dict(device=dev, seed=SEED, plane=PLANE)
    before = (k3.emt_matmul_experts_dx.launches,
              k3.emt_matmul_experts_dw.launches)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    rt = torch.tensor(rho, requires_grad=True)
    sig = dev.sigma_rel(rt)
    y, s, m = k3.plain_experts(xt, wt, sig, **kw)
    assert not m.requires_grad
    gt, gst = torch.tensor(g), torch.tensor(gs)
    adx, adw, adsig = torch.autograd.grad(
        (y * gt).sum() + gst * s, [xt, wt, sig])
    with torch.no_grad():
        dx = k3.plain_experts_dx(gt, wt, sig, **kw)
        dw, dsig = k3.plain_experts_dw(xt, gt, wt, sig, gst, **kw)
    _close(dx, adx, 1e-6, "dx vs autograd")
    _close(dw, adw, 1e-6, "dw vs autograd")
    terms = float((adw.abs() * wt.abs()).sum().detach())
    assert abs(dsig.item() - adsig.item()) <= 1e-6 * terms
    jdx, jdw, jdrho = _jax_vjp(x, w, g, rho, gs)
    _close(dx, jdx, 1e-6, "dx vs jax")
    _close(dw, jdw, 1e-6, "dw vs jax")
    if integer:
        assert np.array_equal(dw.numpy(), np.asarray(jdw))
    # drho through sigma_rel: the port's dsigma chained by autograd
    (drho,) = torch.autograd.grad(sig, [rt], dsig)
    dsdr = torch.autograd.grad(dev.sigma_rel(rt), [rt])[0].abs().item()
    assert abs(drho.item() - float(jdrho)) <= 1e-6 * terms * dsdr
    # the plain versions launch nothing
    assert before == (k3.emt_matmul_experts_dx.launches,
                      k3.emt_matmul_experts_dw.launches)


@pytest.mark.parametrize("E,M,K,N", EXPERT_CASES[:2])
def test_experts_function_equals_autograd(E, M, K, N):
    """plain_experts_differentiable (the autograd Function the card's
    kernels sit in, on the plain versions): the product and both
    statistics equal the plain forward's, and the gradients of x, w and
    sigma equal torch's autograd through it, under a loss that uses the
    product, the sum (technique B) and the detached max (the energy)."""
    x, w, g = _inputs(E, M, K, N, False, seed=1)
    dev = TDevice()
    kw = dict(device=dev, seed=SEED, plane=PLANE)
    grads = []
    for fn in (k3.plain_experts, k3.plain_experts_differentiable):
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        rt = torch.tensor(2.5, requires_grad=True)
        y, s, m = fn(xt, wt, dev.sigma_rel(rt), **kw)
        loss = (y * torch.tensor(g)).sum() + 0.1 * s + m.detach()
        grads.append([y.detach(), s.detach(), m]
                     + list(torch.autograd.grad(loss, [xt, wt, rt])))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("E,M,K,N", [(64, 120, 2048, 1408),
                                     (64, 120, 1408, 2048),
                                     (16, 20, 4096, 14336),
                                     (3, 130, 129, 257), (1, 5, 130, 200)])
def test_experts_backward_plans(E, M, K, N):
    """plan_dx / plan_dw over a stack (the C entries' grids: E x the one
    product's tiles x slabs along the grid's x and y): every expert's
    tiles counted, slabs of whole 32-deep tiles covering the reduction,
    the workspace E slabs of the output a split, four dsigma partials a
    tile; one expert plans as K3-dx / K3-dw (experts=0)."""
    from repro_torch.kernels import splitk
    sms = 132
    for p, red, (rows, cols) in (
            (k3.plan_dx(M, K, N, sms, experts=E), N, (M, K)),
            (k3.plan_dw(M, K, N, sms, experts=E), M, (K, N))):
        assert p.E == E and (p.M, p.N, p.K) == (rows, cols, red)
        tiles = splitk.cdiv(rows, 128) * splitk.cdiv(cols, 128)
        assert p.tiles == E * tiles
        assert p.k_slab % 32 == 0 and (p.splits - 1) * p.k_slab < red
        assert p.splits * p.k_slab >= red
    q = k3.plan_dw(M, K, N, sms, experts=E)
    ws, part = k3.dw_buffer_floats(q)
    assert part == 4 * q.tiles + 1
    assert ws == (q.splits * E * K * N if q.splits > 1 else 0)
    if E == 1:
        assert k3.plan_dx(M, K, N, sms, experts=1) == k3.plan_dx(M, K, N,
                                                                   sms)
        assert k3.plan_dw(M, K, N, sms, experts=1) == k3.plan_dw(M, K, N,
                                                                   sms)


@pytest.fixture(scope="module")
def moonshot():
    """moonshot's mixed smoke stack in both packages on shared seeded
    weights, and JAX's jitted value_and_grad of its training loss."""
    cj = j_get_config(MOE, smoke=True, placement="mixed").replace(
        dtype=jnp.float32, remat=False)
    ct = t_get_config(MOE, smoke=True, placement="mixed").replace(
        dtype=torch.float32)
    params_j, params_t = shared_weights(ct)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b, s: jlm.train_loss(p, b, cj, JCtx(seed=s), lam=1e-3),
        has_aux=True))
    return cj, ct, params_j, params_t, jgrad


def test_moonshot_mixed_gradients_match_jax(moonshot):
    """The loss, its metrics and every gradient leaf of a training step
    (experts technique A on RRAM through the experts entry, routers on
    SRAM, attention on PCM; lam 1e-3 so technique B's term over the noisy
    stacks moves the gradients) against jax.value_and_grad."""
    cj, ct, params_j, params_t, jgrad = moonshot
    for _, p in flatten_with_paths(params_t):
        p.requires_grad_(True)
    batch = SyntheticLM(ct.vocab_size, 16, 2, device="cpu").arrays_at(3)
    (jloss, jm), jgrads = jgrad(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.uint32(3))
    loss, metrics, grads = make_grad_fn(ct, 1e-3)(
        params_t, {k: torch.from_numpy(v) for k, v in batch.items()}, 3)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for k in ("ce", "reg", "energy_uj", "rho_mean", "aux_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    jflat = dict(_tree_to_arrays(jgrads))
    tflat = flatten_with_paths(grads)
    assert sorted(jflat) == [p for p, _ in tflat]
    experts = [p for p in jflat if p.endswith(("/wg", "/wu", "/wd"))
               and "ffn" in p]
    assert experts, sorted(jflat)
    for path, g in tflat:
        assert torch.isfinite(g).all(), path
        _close(g.numpy(), jflat[path], 1e-5, path)
        assert np.abs(jflat[path]).max() > 0 or path.endswith("rho_raw"), \
            path
    # the expert stacks' rho (techniques A and B over the noisy stacks)
    rho = [p for p in jflat if p.endswith("ffn/rho_raw")]
    assert rho and all(np.abs(jflat[p]).max() > 0 for p in rho)


def test_launcher_trains_moonshot_mixed_on_the_cpu(tmp_path):
    """``launch.train --arch moonshot-v1-16b-a3b --smoke --placement
    mixed``: two steps on the CPU, finite losses, every trainable rho_raw
    moved."""
    from repro_torch.launch import train as ttrain
    argv = ["--arch", MOE, "--smoke", "--placement", "mixed", "--steps",
            "2", "--batch", "2", "--seq", "8", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "100"]
    run = ttrain.setup(argv, torch_device="cpu")
    rho0 = {p: t.detach().clone() for p, t in
            flatten_with_paths(run.state["params"]) if p.endswith("rho_raw")}
    with contextlib.redirect_stdout(io.StringIO()):
        state, hist = ttrain.main(argv, torch_device="cpu")
    assert int(state["step"]) == 2
    assert hist and all(np.isfinite(h["loss"]) for h in hist)
    after = dict(flatten_with_paths(state["params"]))
    # every rho moved but the routers', whose SRAM corner keeps rho fixed
    # (trainable_rho False: no gradient reaches it, in JAX as here)
    frozen = {p for p in rho0 if p.endswith("router/rho_raw")}
    assert not run.cfg.emt_rule_at("dec/layer_000/moe/router").trainable_rho
    assert rho0 and all(torch.equal(after[p], v) == (p in frozen)
                        for p, v in rho0.items())
