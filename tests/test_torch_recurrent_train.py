"""Port parity of training the recurrent stacks against the JAX package,
on the CPU (the plain versions): xlstm-350m (mLSTM and sLSTM blocks,
analog) and jamba-v0.1-52b on the mixed placement (mamba with a dense MLP
on the bit-serial corner, mamba with the mixture of experts through the
experts entry, attention with experts), at smoke widths, float32.

* The loss, its metrics and every gradient leaf of ``lm.train_loss``
  (every mixer from a zero state, as training runs it) against
  ``jax.value_and_grad`` of JAX's on the same seeded weights, at the
  configs' 8-bit DAC with every corner's noise on, on DAC levels recorded
  from JAX's jitted step (ordered host callbacks) and replayed in the port
  with their straight-through gradient kept (``port_parity
  .port_levels_ste``), so that a float32 tie at a level cannot make the two
  differ by a whole level.  At a 24-bit DAC instead, float32 order moved
  levels by an ulp and the gradients by up to 1.7e-5 (xlstm's mLSTM) and,
  through jamba's bit-serial MLPs (a bit-serial read is not continuous in
  its level), by 3.6e-4; on replayed levels both stay near 2e-6.  jamba's
  smoke stack is cut from 8 to its first 4 layers (every block kind it
  has), as in tests/test_torch_recurrent.py.
* The training launcher: ``--arch xlstm-350m --smoke --seq 12``, two
  steps on the CPU.

Tolerances: the loss within 1e-6 relative, the metrics within 1e-5
relative, each gradient leaf within 1e-5 of its largest |value| (float32
order differences of XLA's and torch's sums through a few layers, as
tests/test_torch_train_grad.py holds gemma3-1b).
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import jax_levels, port_levels_ste, shared_weights
from repro.ckpt.checkpoint import _tree_to_arrays
from repro.configs import get_config as j_get_config
from repro.core import emt_linear as jel
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import emt_linear as tel
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train.step import make_grad_fn
from repro_torch.utils.pytrees import flatten_with_paths

XLSTM, JAMBA = "xlstm-350m", "jamba-v0.1-52b"
PLACE = {XLSTM: dict(emt_mode="analog"), JAMBA: dict(placement="mixed")}
LAYERS = {XLSTM: None, JAMBA: 4}
LAM = 1e-3


def _close(a, b, tol, what=""):
    """max |a - b| <= tol * max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b).max()
    assert d <= tol * max(np.abs(b).max(), 1e-30), (what, d, np.abs(b).max())


@pytest.fixture(scope="module", params=[XLSTM, JAMBA])
def stack(request):
    """(arch, JAX config, port config, JAX's and the port's weights, JAX's
    jitted value_and_grad of the training loss)."""
    arch = request.param
    cj = j_get_config(arch, smoke=True, **PLACE[arch])
    ct = t_get_config(arch, smoke=True, **PLACE[arch])
    if LAYERS[arch]:
        cj = cj.replace(num_layers=LAYERS[arch])
        ct = ct.replace(num_layers=LAYERS[arch])
    # without remat: jax.checkpoint turns the aux's layer count into a
    # tracer, which the rho_mean metric cannot take; no value changes
    cj = cj.replace(dtype=jnp.float32, remat=False)
    ct = ct.replace(dtype=torch.float32)
    assert ct.blocks() == cj.blocks()
    params_j, params_t = shared_weights(ct)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b, s: jlm.train_loss(p, b, cj, JCtx(seed=s), lam=LAM),
        has_aux=True))
    return arch, cj, ct, params_j, params_t, jgrad


def test_gradients_match_jax(stack):
    """The loss, ce, reg, energy and aux loss and every gradient leaf
    (each crossbar's w, rho_raw, the mixers' own parameters, the experts'
    stacks) of a training step on a batch of 2 x 12 against
    jax.value_and_grad, on JAX's replayed levels; every gradient finite,
    and some rho with a nonzero gradient."""
    arch, cj, ct, params_j, params_t, jgrad = stack
    for _, p in flatten_with_paths(params_t):
        p.requires_grad_(True)
    batch = SyntheticLM(ct.vocab_size, 12, 2, device="cpu").arrays_at(5)
    levels = []
    with jax_levels(jel, levels):
        (jloss, jm), jgrads = jgrad(
            params_j, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.uint32(5))
    replay = list(levels)
    with port_levels_ste(tel, replay):
        loss, metrics, grads = make_grad_fn(ct, LAM)(
            params_t, {k: torch.from_numpy(v) for k, v in batch.items()}, 5)
    assert levels and not replay
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for k in ("ce", "reg", "energy_uj", "aux_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
    jflat = dict(_tree_to_arrays(jgrads))
    tflat = flatten_with_paths(grads)
    assert sorted(jflat) == [p for p, _ in tflat]
    for path, g in tflat:
        assert torch.isfinite(g).all(), path
        _close(g.numpy(), jflat[path], 1e-5, path)
    rho = [p for p in jflat if p.endswith("rho_raw")]
    assert rho and any(np.abs(jflat[p]).max() > 0 for p in rho)
    if arch == JAMBA:
        assert any(p.endswith("ffn/wg") for p in jflat), sorted(jflat)


def test_launcher_trains_xlstm_on_the_cpu(tmp_path):
    """``launch.train --arch xlstm-350m --smoke --seq 12``: two steps on
    the CPU, finite losses, every rho_raw moved."""
    from repro_torch.launch import train as ttrain
    argv = ["--arch", XLSTM, "--smoke", "--seq", "12", "--steps", "2",
            "--batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "100"]
    run = ttrain.setup(argv, torch_device="cpu")
    rho0 = {p: t.detach().clone() for p, t in
            flatten_with_paths(run.state["params"]) if p.endswith("rho_raw")}
    with contextlib.redirect_stdout(io.StringIO()):
        state, hist = ttrain.main(argv, torch_device="cpu")
    assert int(state["step"]) == 2
    assert hist and all(np.isfinite(h["loss"]) for h in hist)
    after = dict(flatten_with_paths(state["params"]))
    assert rho0 and all(not torch.equal(after[p], v)
                        for p, v in rho0.items())
