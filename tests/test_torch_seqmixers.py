"""Port parity of the recurrent sequence mixers (``repro_torch.models.mamba``
and ``repro_torch.models.xlstm``) against ``repro.models.mamba`` and
``repro.models.xlstm``, on identical weights (JAX's init, bridged by path)
and identical seeded numpy inputs.

The six tests of ``tests/test_seqmixers.py`` are mirrored: each holds the
port to JAX's invariant (the selective scan against a step-by-step
recurrence, full-sequence mixing against token-by-token decoding with the
carried state, mLSTM's chunking invariance, the exact sLSTM recurrence)
with JAX's tolerances, and the port's outputs and states to JAX's on the
same inputs.  Tolerances against JAX: 1e-5 absolute (float32; the scans
combine in other orders: the port's Hillis-Steele scan, JAX's
``associative_scan``), on the ideal and the analog corner (technique A on
the hash backend, per-row DAC scale), whose DAC levels are replayed from
the JAX run (jitted, the levels recorded by ordered host callbacks) so
that a level at a rounding tie cannot flip.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.configs.common import emt_preset as jpreset
from repro.core import emt_linear as jel
from repro.core.emt_linear import IDEAL as JIDEAL
from repro.models import mamba as jmam
from repro.models import xlstm as jxl
from repro.models.config import ModelConfig as JConfig
from repro.models.context import Ctx as JCtx
from repro.nn.param import init_params
from repro_torch.configs.common import emt_preset as tpreset
from repro_torch.core import emt_linear as tel
from repro_torch.core.emt_linear import IDEAL as TIDEAL
from repro_torch.models import mamba as tmam
from repro_torch.models import xlstm as txl
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.context import Ctx as TCtx
from repro_torch.nn.param import load_arrays

BASE = dict(name="t", family="ssm", num_layers=1, d_model=32, num_heads=2,
            num_kv_heads=2, d_ff=0, vocab_size=64, head_dim=16)
MIXERS = {"mamba": (jmam.mamba_specs, jmam.mamba, tmam.mamba_specs,
                    tmam.mamba),
          "mlstm": (jxl.mlstm_specs, jxl.mlstm, txl.mlstm_specs, txl.mlstm),
          "slstm": (jxl.slstm_specs, jxl.slstm, txl.slstm_specs, txl.slstm)}
TOL = 1e-5


def _emt(mode):
    if mode == "ideal":
        return JIDEAL, TIDEAL
    return tuple(e.replace(quant=dataclasses.replace(e.quant, a_per_row=True))
                 for e in (jpreset("analog"), tpreset("analog")))


def _cfgs(mode="ideal", **kw):
    ej, et = _emt(mode)
    return (JConfig(**BASE, dtype=jnp.float32, emt=ej, **kw),
            TConfig(**BASE, dtype=torch.float32, emt=et, **kw))


def _params(kind, cfg_j, cfg_t, seed=0, recurrent=False):
    """JAX's init of `kind`'s parameters and the port's tree of the same
    arrays; `recurrent` also fills sLSTM's recurrent matrices (zeros at
    init) from a seeded normal, so that the exact variant recurs."""
    jspecs, _, tspecs, _ = MIXERS[kind]
    arrays = _tree_to_arrays(init_params(jspecs(cfg_j),
                                         jax.random.PRNGKey(seed)))
    if recurrent:
        rng = np.random.default_rng(seed + 1)
        for nm in ("rz", "ri", "rf", "ro"):
            arrays[nm] = (rng.standard_normal(arrays[nm].shape) * 0.2
                          ).astype(np.float32)
    params_t = load_arrays(tspecs(cfg_t), arrays, device="cpu")
    params_j = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params_t)
    return params_j, params_t


def _x(shape, seed=1, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@contextlib.contextmanager
def _levels(mod, out, replay=None):
    """Record every projection's DAC (levels, scale) in `out`; with
    `replay` (a list in call order), return those instead."""
    orig = mod.quant_levels

    def quant(x, bits, axis=None):
        if replay is None:
            lv, sc = orig(x, bits, axis=axis)
        else:
            lv, sc = (torch.tensor(a) for a in replay.pop(0))
            assert tuple(lv.shape) == tuple(x.shape)
        out.append((np.asarray(lv), np.asarray(sc)))
        return lv, sc

    mod.quant_levels = quant
    try:
        yield
    finally:
        mod.quant_levels = orig


@contextlib.contextmanager
def _jax_levels(out):
    """Record every projection's DAC (levels, scale) of JAX's jitted calls
    in `out`, in program order (ordered host callbacks; the block waits
    for them on exit)."""
    orig = jel.quant_levels

    def quant(x, bits, axis=None):
        lv, sc = orig(x, bits, axis=axis)
        jax.debug.callback(
            lambda a, b: out.append((np.asarray(a), np.asarray(b))), lv, sc,
            ordered=True)
        return lv, sc

    jel.quant_levels = quant
    try:
        yield
        jax.effects_barrier()
    finally:
        jel.quant_levels = orig


@functools.lru_cache(maxsize=None)
def _jax_mixer(kind, cfg_j, chunk):
    """JAX's `kind` mixer jitted for `cfg_j` (`chunk`: the mLSTM chunk it
    was traced with)."""
    fn = MIXERS[kind][1]
    return jax.jit(lambda p, x, st: fn(
        p, x, cfg_j, ctx=JCtx(seed=jnp.uint32(7)),
        tag=f"dec/layer_000/{kind}", state=st))


def _run_both(kind, cfg_j, cfg_t, params_j, params_t, x, state=None):
    """The mixer on both packages (JAX jitted with its DAC levels
    recorded, the port replaying them).  Returns ((y, state) of JAX, (y,
    state) of the port) as numpy."""
    tfn = MIXERS[kind][3]
    lv = []
    with _jax_levels(lv):
        yj, aj, sj = _jax_mixer(kind, cfg_j, jxl.MLSTM_CHUNK)(
            params_j, jnp.asarray(x), None if state is None else
            {k: jnp.asarray(v) for k, v in state.items()})
    with _levels(tel, [], replay=list(lv)):
        yt, at, st = tfn(params_t, torch.from_numpy(x), cfg_t,
                         ctx=TCtx(seed=7), tag=f"dec/layer_000/{kind}",
                         state=None if state is None else
                         {k: torch.from_numpy(np.array(v))
                          for k, v in state.items()})
    np.testing.assert_allclose(float(at["energy_pj"]),
                               float(aj["energy_pj"]), rtol=1e-5)
    conv = (lambda s: None if s is None else
            {k: np.asarray(v) for k, v in s.items()})
    return ((np.asarray(yj), conv(sj)),
            (yt.numpy(), None if st is None else
             {k: v.numpy() for k, v in st.items()}))


def _zero_state(kind, cfg_t, B):
    specs = {"mamba": tmam.mamba_state_specs, "mlstm": txl.mlstm_state_specs,
             "slstm": txl.slstm_state_specs}[kind](cfg_t, B)
    return {k: np.zeros(shape, np.float32) for k, (shape, _) in specs.items()}


def _same(a, b, tol=TOL):
    (ya, sa), (yb, sb) = a, b
    np.testing.assert_allclose(yb, ya, rtol=0, atol=tol)
    assert (sa is None) == (sb is None)
    if sa is not None:
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_allclose(sb[k], sa[k], rtol=0, atol=tol,
                                       err_msg=k)


def test_selective_scan_matches_lax_scan():
    """The port's chunked Hillis-Steele scan against the step-by-step
    recurrence (lax.scan, JAX's test's tolerance) and against JAX's
    associative scan, from zero and from a carried state; chunk 5 of 16
    carries the state across three chunk edges."""
    B, S, DI, N = 2, 16, 8, 4
    rng = np.random.default_rng(0)
    dA = rng.uniform(0.1, 0.95, (B, S, DI, N)).astype(np.float32)
    dBx = rng.standard_normal((B, S, DI, N)).astype(np.float32)
    h0 = rng.standard_normal((B, DI, N)).astype(np.float32)
    a, b = jnp.asarray(dA), jnp.asarray(dBx)
    for init in (None, h0):
        def step(h, t):
            h = a[:, t] * h + b[:, t]
            return h, h
        _, hs = jax.lax.scan(step, jnp.zeros((B, DI, N)) if init is None
                             else jnp.asarray(init), jnp.arange(S))
        ref = np.asarray(jnp.moveaxis(hs, 0, 1))
        hj, hj_last = jmam._selective_scan(
            jnp.asarray(dA), jnp.asarray(dBx),
            None if init is None else jnp.asarray(init), chunk=5)
        ht, ht_last = tmam._selective_scan(
            torch.from_numpy(dA), torch.from_numpy(dBx),
            None if init is None else torch.from_numpy(init), chunk=5)
        np.testing.assert_allclose(ht.numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ht_last.numpy(), ref[:, -1], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(ht_last.numpy(), np.asarray(hj_last),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["ideal", "analog"])
@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_matches_jax(kind, mode):
    """Full-sequence mixing from no state, and from a carried random state
    (the legacy prefill passes the zeroed cache; decode passes the slot's
    state): outputs, new states and energy equal JAX's."""
    cfg_j, cfg_t = _cfgs(mode)
    params_j, params_t = _params(kind, cfg_j, cfg_t)
    x = _x((2, 11, cfg_t.d_model))
    _same(*_run_both(kind, cfg_j, cfg_t, params_j, params_t, x))
    rng = np.random.default_rng(3)
    state = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
             for k, v in _zero_state(kind, cfg_t, 2).items()}
    if kind == "slstm":                     # the normalizer state is >= 0
        state["n"] = np.abs(state["n"])
    _same(*_run_both(kind, cfg_j, cfg_t, params_j, params_t, x, state))


def _prefill_decode(kind, S, B=2, tol=2e-4):
    """Full-sequence mixing against token-by-token decoding with the
    carried state on the port (JAX's invariant and tolerance `tol`), and
    each decoding step's output and state against JAX's."""
    cfg_j, cfg_t = _cfgs()
    params_j, params_t = _params(kind, cfg_j, cfg_t)
    x = _x((B, S, cfg_t.d_model))
    full_j, full_t = _run_both(kind, cfg_j, cfg_t, params_j, params_t, x)
    _same(full_j, full_t)
    state = _zero_state(kind, cfg_t, B)
    ys = []
    for t in range(S):
        step_j, step_t = _run_both(kind, cfg_j, cfg_t, params_j, params_t,
                                   x[:, t:t + 1], state)
        _same(step_j, step_t)
        ys.append(step_t[0])
        state = step_t[1]
    np.testing.assert_allclose(np.concatenate(ys, axis=1), full_t[0],
                               rtol=tol, atol=tol)
    return full_t[1], state


def test_mamba_prefill_decode_consistency():
    full, step = _prefill_decode("mamba", 10)
    np.testing.assert_allclose(step["h"], full["h"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(step["conv"], full["conv"], rtol=2e-4,
                               atol=2e-4)


def test_mlstm_prefill_decode_consistency():
    full, step = _prefill_decode("mlstm", 9, tol=2e-3)
    np.testing.assert_allclose(step["C"], full["C"], rtol=2e-3, atol=2e-3)


def test_slstm_prefill_decode_consistency():
    full, step = _prefill_decode("slstm", 8)
    for k in ("c", "n"):
        np.testing.assert_allclose(step[k], full[k], rtol=2e-4, atol=2e-4)


def test_mlstm_chunking_invariance():
    """Chunks of 4 against one chunk of 12 (JAX's test), each against
    JAX's at the same chunk size."""
    cfg_j, cfg_t = _cfgs()
    params_j, params_t = _params("mlstm", cfg_j, cfg_t)
    x = _x((1, 12, cfg_t.d_model))
    out = {}
    old = (jxl.MLSTM_CHUNK, txl.MLSTM_CHUNK)
    try:
        for chunk in (4, 12):
            jxl.MLSTM_CHUNK = txl.MLSTM_CHUNK = chunk
            a, b = _run_both("mlstm", cfg_j, cfg_t, params_j, params_t, x)
            _same(a, b)
            out[chunk] = b[0]
    finally:
        jxl.MLSTM_CHUNK, txl.MLSTM_CHUNK = old
    np.testing.assert_allclose(out[4], out[12], rtol=1e-4, atol=1e-4)


def test_slstm_recurrent_variant_matches_jax():
    """The exact R-matrix recurrence (``slstm_recurrent``, lax.scan in
    JAX), with nonzero recurrent matrices: finite, JAX's outputs, no
    state; a one-token call takes the scan form and returns one."""
    cfg_j, cfg_t = _cfgs(slstm_recurrent=True)
    params_j, params_t = _params("slstm", cfg_j, cfg_t, recurrent=True)
    x = _x((2, 6, cfg_t.d_model), scale=1.0)
    (yj, sj), (yt, st) = _run_both("slstm", cfg_j, cfg_t, params_j,
                                   params_t, x)
    assert yt.shape == x.shape and np.isfinite(yt).all()
    assert sj is None and st is None
    np.testing.assert_allclose(yt, yj, rtol=0, atol=TOL)
    # the recurrent matrices matter: the scan form gives other outputs
    cfg_s = cfg_t.replace(slstm_recurrent=False)
    ys, _, _ = txl.slstm(params_t, torch.from_numpy(x), cfg_s, ctx=TCtx(),
                         tag="s")
    assert np.abs(ys.numpy() - yt).max() > 1e-3
    _same(*_run_both("slstm", cfg_j, cfg_t, params_j, params_t, x[:, :1],
                     _zero_state("slstm", cfg_t, 2)))
