"""Port parity of the contiguous KV cache (``paged=False``, the default of
JAX's ServingEngine and ServeSpec): a ``(batch, max_len, ...)`` region per
slot and layer, a window-sized ring on a sliding-window layer.

* Model steps: ``lm.chunk_step`` and ``lm.decode_step`` without page
  tables on the shrunk all-global gemma3-1b (2 layers, per-row DAC scale),
  against JAX: logits within 1e-4 absolute (float32, |logit| < 1), caches
  within 1e-5, energy within rtol 1e-5, kv_reads equal.
* Engines, chunked prefill, all-global: the port's contiguous engine
  against JAX's contiguous engine (tokens identical, ledgers within rtol
  1e-5) and against its own paged engine (tokens identical: the matrix's
  kv axis).
* Engines, legacy bucketed admission on gemma3-1b smoke as published (5
  ring layers of window 8 and 1 global): JAX's contiguous engine (run op
  by op, its DAC levels recorded) against the port's contiguous and paged
  engines: tokens identical; ledgers within rtol 1e-5 on runs replaying
  JAX's levels (free-running, a level at a float32 rounding tie can round
  the other way, ROADMAP Queue 3).
* seamless-m4t-medium smoke on the contiguous layout (legacy prefill, the
  cross attention read from the slot's region): JAX's tokens and ledgers.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.core import emt_linear as jel
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro.nn.param import init_params
from repro.serve.engine import GenRequest as JReq
from repro.serve.engine import ServingEngine as JEng
from repro.serve.spec import ServeSpec
from repro_torch.core import emt_linear as tel
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx
from repro_torch.serve.engine import GenRequest as TReq
from repro_torch.serve.engine import ServingEngine as TEng
from repro_torch.serve.spec import build_config


def _models(arch="gemma3-1b", all_global=True, a_per_row=True,
            **overrides):
    cfg_j = ServeSpec(arch=arch, mode="analog", smoke=True,
                      all_global=all_global, a_per_row=a_per_row,
                      model_overrides=overrides or None).build_config()
    params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
    cfg_t = build_config(arch, smoke=True, all_global=all_global,
                         a_per_row=a_per_row,
                         model_overrides=overrides or None)
    params_t = tlm.load_jax_arrays(_tree_to_arrays(params_j), cfg_t,
                                   device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def global2():
    return _models(num_layers=2)


def test_contiguous_chunk_and_decode_steps_match_jax(global2):
    """A chunk step (rows at start 0 with 16 lanes and 5, one row idle)
    and three decode steps on the contiguous cache, against JAX's steps
    without page tables."""
    cfg_j, params_j, cfg_t, params_t = global2
    B, L, C = 3, 40, 16
    cj = jlm.init_cache(cfg_j, B, L)
    ct = tlm.init_cache(cfg_t, B, L, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_t.vocab_size, (B, C)).astype(np.int32)
    start = np.zeros(B, np.int32)
    ntok = np.asarray([16, 5, 1], np.int32)
    act = np.asarray([True, True, False])
    lj, cj, aj = jlm.chunk_step(
        params_j, cj, jnp.asarray(tokens), jnp.asarray(start),
        jnp.asarray(ntok), cfg_j, JCtx(seed=jnp.uint32(7)),
        active=jnp.asarray(act))
    lt, ct, at = tlm.chunk_step(
        params_t, ct, torch.from_numpy(tokens).long(),
        torch.from_numpy(start).long(), torch.from_numpy(ntok).long(),
        cfg_t, TCtx(seed=7), active=torch.from_numpy(act))
    idx = ntok.astype(np.int64)

    def held(lj, lt, aj, at, what):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=1e-4, err_msg=what)
        for name in cj:
            for k in ("k", "v"):
                np.testing.assert_allclose(
                    ct[name][k].numpy(), np.asarray(cj[name][k]), rtol=0,
                    atol=1e-5, err_msg=f"{what} {name}/{k}")
        np.testing.assert_allclose(float(at["energy_pj"]),
                                   float(aj["energy_pj"]), rtol=1e-5)
        assert float(at["kv_reads"]) == float(aj["kv_reads"])

    held(lj, lt, aj, at, "chunk step")
    assert float(ct["layer_000"]["k"][2].abs().max()) == 0.0   # idle row
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for step in range(3):
        lj, cj, aj = jlm.decode_step(
            params_j, cj, jnp.asarray(tok), jnp.asarray(idx, jnp.int32),
            cfg_j, JCtx(seed=jnp.uint32(7)), active=jnp.asarray(act))
        lt, ct, at = tlm.decode_step(
            params_t, ct, torch.from_numpy(tok).long(),
            torch.from_numpy(idx), cfg_t, TCtx(seed=7),
            active=torch.from_numpy(act))
        held(lj, lt, aj, at, f"decode step {step}")
        np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(lj, -1)))
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        idx = idx + 1


ENGINE = dict(batch_size=3, max_len=48, seed=7, block_size=8,
              prefill_chunk=8)


def _specs(lens=(11, 3, 20, 7, 14)):
    rng = np.random.default_rng(3)
    out = []
    for i, plen in enumerate(lens):
        kw = dict(prompt=rng.integers(0, 512, plen).astype(np.int32),
                  max_new=6 + i, seed=100 + i)
        if i in (1, 3):
            kw.update(temperature=0.8, top_k=40)
        out.append(kw)
    return out


def _same_tokens(ra, rb):
    assert [r.rid for r in ra] == [r.rid for r in rb]
    for a, b in zip(ra, rb):
        np.testing.assert_array_equal(b.tokens, a.tokens,
                                      err_msg=f"rid {a.rid}")
        assert (b.done_reason, b.steps) == (a.done_reason, a.steps)


def _same_ledgers(ea, ra, eb, rb):
    for a, b in zip(ra, rb):
        np.testing.assert_allclose(b.energy_pj, a.energy_pj, rtol=1e-5)
        np.testing.assert_allclose(b.prefill_energy_pj, a.prefill_energy_pj,
                                   rtol=1e-5)
    ma, mb = ea.metrics(), eb.metrics()
    for k in ("total_energy_pj", "idle_energy_pj"):
        np.testing.assert_allclose(mb[k], ma[k], rtol=1e-5, err_msg=k)
    assert mb["kv_reads_total"] == ma["kv_reads_total"]
    for k in ("steps", "peak_concurrent", "prefill_tokens_total"):
        assert mb[k] == ma[k], k
    assert eb.energy_conserved(rb) and ea.energy_conserved(ra)


def test_contiguous_engine_is_the_default_and_serves_jax_tokens(global2):
    """The contiguous engine (chunked, all-global) against JAX's, on the
    staggered schedule of test_torch_engine, and against the port's paged
    engine: the same tokens."""
    cfg_j, params_j, cfg_t, params_t = global2
    ej = JEng(cfg_j, params_j, fresh_noise=False, **ENGINE)
    rj = ej.serve([JReq(**s) for s in _specs()], stagger=2)
    et = TEng(cfg_t, params_t, fresh_noise=False, device="cpu", **ENGINE)
    assert not et.paged and et.kv is None and et.chunked
    rt = et.serve([TReq(**s) for s in _specs()], stagger=2)
    _same_tokens(rj, rt)
    _same_ledgers(ej, rj, et, rt)
    ep = TEng(cfg_t, params_t, fresh_noise=False, paged=True, device="cpu",
              **ENGINE)
    _same_tokens(rt, ep.serve([TReq(**s) for s in _specs()], stagger=2))
    for blk in et.cache.values():                  # retired regions zeroed
        assert all(float(t.abs().max()) == 0.0 for t in blk.values())


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


@pytest.fixture(scope="module")
def legacy_ring():
    """gemma3-1b smoke as published (ring layers), legacy bucketed
    admission: JAX's contiguous engine op by op with its DAC levels
    recorded, then the port's contiguous and paged engines free-running
    and replaying them."""
    cfg_j, params_j, cfg_t, params_t = _models(all_global=False)
    assert "local" in cfg_t.blocks() and cfg_t.sliding_window == 8
    kw = dict(ENGINE, block_size=16, chunked_prefill=False)
    specs = _specs((11, 3, 20, 7, 30))
    lv = []
    with jax.disable_jit(), _levels(jel, lv):
        ej = JEng(cfg_j, params_j, fresh_noise=False, **kw)
        runs = {"jax": (ej, ej.serve([JReq(**s) for s in specs],
                                     stagger=2))}
    for paged in (False, True):
        for replay in (None, list(lv)):
            et = TEng(cfg_t, params_t, fresh_noise=False, paged=paged,
                      device="cpu", **kw)
            with _levels(tel, [], replay):
                res = et.serve([TReq(**s) for s in specs], stagger=2)
            runs[("paged" if paged else "contiguous")
                 + ("/replay" if replay is not None else "")] = (et, res)
    return runs


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_legacy_admission_on_the_ring_stack_matches_jax(legacy_ring, layout):
    """Left-padded power-of-two prompt buckets (4 to 32, the 32 bucket
    wrapping the window-8 rings at prefill) copied into the slot's region
    or blocks: JAX's tokens free-running, JAX's ledgers on its levels."""
    ej, rj = legacy_ring["jax"]
    et, rt = legacy_ring[layout]
    assert not et.chunked and et.metrics()["prefill_tokens_total"] == 0
    _same_tokens(rj, rt)
    assert et.energy_conserved(rt)
    ep, rp = legacy_ring[f"{layout}/replay"]
    _same_tokens(rj, rp)
    _same_ledgers(ej, rj, ep, rp)
    if layout == "paged":
        et.kv.check()
        assert et.kv.pool_l.num_free == et.kv.pool_l.num_blocks


def test_seamless_contiguous_engine_matches_jax():
    """seamless-m4t-medium smoke (per-tensor DAC scale) on the contiguous
    layout: the legacy prefill's cross K/V of the bucket's length copied
    into the slot's max_len region and read under each row's encoder
    length, as test_torch_encdec_engine's co-tenant schedule runs it
    paged."""
    cfg_j, params_j, cfg_t, params_t = _models("seamless-m4t-medium",
                                               a_per_row=False)
    rng = np.random.default_rng(3)
    specs = [dict(prompt=rng.integers(0, 512, n).astype(np.int32),
                  max_new=4, seed=i) for i, n in enumerate([5, 3])]
    kw = dict(batch_size=2, max_len=16, seed=3)
    ej = JEng(cfg_j, params_j, fresh_noise=False, **kw)
    rj = ej.serve([JReq(**s) for s in specs], stagger=1)
    et = TEng(cfg_t, params_t, fresh_noise=False, device="cpu", **kw)
    rt = et.serve([TReq(**s) for s in specs], stagger=1)
    assert not et.chunked and not et.paged
    assert set(et.cache["layer_000"]) == {"k", "v", "ck", "cv"}
    _same_tokens(rj, rt)
    _same_ledgers(ej, rj, et, rt)
    mj, mt = ej.metrics(), et.metrics()
    for k, v in mj["corner_energy_pj"].items():
        np.testing.assert_allclose(mt["corner_energy_pj"][k], v, rtol=1e-5)
    for blk in et.cache.values():
        assert all(float(t.abs().max()) == 0.0 for t in blk.values())
