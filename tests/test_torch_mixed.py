"""Port parity of the slice: gemma3-1b smoke served on the "mixed" device
placement (attention analog on PCM, MLPs bit-serial on RRAM, the tied
unembed analog on PCM), all-global, per-row DAC scale, frozen noise, paged
KV and chunked prefill, against the JAX package on identical weights.
The stack is cut to 2 layers, as the other engine parity tests cut it.

Tolerances: chunk-step and decode-step logits within 1e-4 absolute
(float32, |logit| < 1); greedy token streams identical; total, per-request
and per-corner energy within rtol 1e-5 (float32 sums of weight-sized
reductions in a different order) wherever both packages feed the crossbars
the same DAC levels.  Bit-serial energy bills the popcount of every level
(Eq. 19), so one level that rounds the other way at a float32 tie (63 vs
64: popcount 6 vs 1) moves a step's ledger by ~1e-4: the engine test holds
the ledgers on a run that replays the JAX run's levels, and on the port's
own run checks that it differs only in steps where levels flipped, from a
first flip at a rounding tie.  The JAX engine runs once per module, op by
op, so its levels can be recorded.
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
from repro.serve.kv_pool import PagedKV as JKV
from repro.serve.spec import ServeSpec
from repro_torch.core import emt_linear as tel
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx
from repro_torch.serve.engine import GenRequest as TReq
from repro_torch.serve.engine import ServingEngine as TEng
from repro_torch.serve.kv_pool import PagedKV as TKV
from repro_torch.serve.spec import build_config

ENGINE = dict(batch_size=3, max_len=48, seed=7, paged=True, block_size=8,
              prefill_chunk=8)
SPEC = dict(arch="gemma3-1b", placement="mixed", all_global=True,
            a_per_row=True, frozen_noise=True, smoke=True)


@pytest.fixture(scope="module")
def models():
    cfg_j = ServeSpec(**SPEC).build_config().replace(num_layers=2)
    params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
    cfg_t = build_config(smoke=True, placement="mixed", all_global=True,
                         a_per_row=True, model_overrides={"num_layers": 2})
    params_t = tlm.load_jax_arrays(_tree_to_arrays(params_j), cfg_t,
                                   device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _requests(Req):
    rng = np.random.default_rng(4)
    return [Req(prompt=rng.integers(0, 512, plen).astype(np.int32),
                max_new=5 + i, seed=100 + i)
            for i, plen in enumerate([11, 3, 20, 7, 14])]


@contextlib.contextmanager
def _patched(obj, name, fn):
    orig = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def _run(eng, Req, levels, steps, replay=None):
    """Serve the requests on `eng`, appending every projection's DAC
    (levels, scale) to `levels` and every step's per-corner energy to
    `steps`.  With `replay` (a list of (levels, scale) as numpy arrays in
    call order) the port's quantizer returns those instead of its own."""
    jax_side = isinstance(eng, JEng)
    mod = jel if jax_side else tel
    cls = JEng if jax_side else TEng

    def quant(x, bits, axis=None):
        if replay is not None:
            lv, sc = replay.pop(0)
            assert lv.shape == tuple(x.shape)
            out = torch.tensor(lv), torch.tensor(sc)
        else:
            out = orig_q(x, bits, axis=axis)
        levels.append((np.asarray(out[0]), np.asarray(out[1]),
                       np.asarray(x)))
        return out

    def book(self, aux, active):
        steps.append({n: float(c["energy_pj"])
                      for n, c in aux["corners"].items()})
        return orig_b(self, aux, active)

    with _patched(mod, "quant_levels", quant) as orig_q, \
            _patched(cls, "_book_step", book) as orig_b:
        return eng.serve(_requests(Req), stagger=2)


@pytest.fixture(scope="module")
def served(models):
    """The JAX engine (run op by op, so its DAC levels can be recorded) and
    the port's engine serve the same staggered greedy requests; the port
    runs twice: on its own, and replaying the JAX run's DAC levels.  The
    port's engine gets the mixed placement through its `placement=`
    argument, on an analog config built for the same parameter tree."""
    cfg_j, params_j, cfg_t, params_t = models
    out = {}
    with jax.disable_jit():
        ej = JEng(cfg_j, params_j, fresh_noise=False, **ENGINE)
        lv, st = [], []
        out["jax"] = (ej, _run(ej, JReq, lv, st), lv, st)
    analog = build_config(smoke=True, all_global=True, a_per_row=True,
                          model_overrides={"num_layers": 2})
    for tag, replay in (("torch", None),
                        ("replay", [(a, b) for a, b, _ in lv])):
        et = TEng(analog, params_t, fresh_noise=False, placement=cfg_t.emt,
                  device="cpu", **ENGINE)
        lv_t, st_t = [], []
        out[tag] = (et, _run(et, TReq, lv_t, st_t, replay), lv_t, st_t)
    return out


def test_chunk_and_decode_logits_match(models):
    cfg_j, params_j, cfg_t, params_t = models
    B, L, bs = 3, 48, 8
    nb = B * L // bs
    jkv, tkv = JKV(B, L, bs, nb), TKV(B, L, bs, nb)
    for s in range(B):
        assert jkv.admit(s, 12, 8) and tkv.admit(s, 12, 8)
        for p in range(12):
            jkv.ensure(s, p)
            tkv.ensure(s, p)
    tg, tl = jkv.gather_tables()
    jt = {"global": jnp.asarray(tg), "local": jnp.asarray(tl)}
    tt = {"global": torch.from_numpy(tg)}
    jlens = jlm.paged_lens(cfg_j, L)
    tlens = tlm.clamped_lens(tlm.paged_lens(cfg_t, L), L)
    cj = jlm.init_paged_cache(cfg_j, B, L, bs, nb)
    ct = tlm.init_paged_cache(cfg_t, B, L, bs, nb, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_t.vocab_size, (B, 8)).astype(np.int32)
    start = np.zeros(B, np.int32)
    ntok = np.asarray([8, 5, 8], np.int32)
    act = np.ones(B, bool)
    lj, cj, aj = jlm.chunk_step(
        params_j, cj, jnp.asarray(tokens), jnp.asarray(start),
        jnp.asarray(ntok), cfg_j, JCtx(seed=jnp.uint32(7)),
        active=jnp.asarray(act), page_tables=jt, page_lens=jlens)
    lt, ct, at = tlm.chunk_step(
        params_t, ct, torch.from_numpy(tokens).long(),
        torch.from_numpy(start).long(), torch.from_numpy(ntok).long(),
        cfg_t, TCtx(seed=7), active=torch.from_numpy(act), page_tables=tt,
        page_lens=tlens)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)
    assert set(at["corners"]) == set(aj["corners"]) == {"pcm", "rram"}
    for name in ("pcm", "rram"):
        np.testing.assert_allclose(float(at["corners"][name]["energy_pj"]),
                                   float(aj["corners"][name]["energy_pj"]),
                                   rtol=1e-5, err_msg=name)
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    lj, _, aj = jlm.decode_step(
        params_j, cj, jnp.asarray(tok), jnp.asarray(ntok), cfg_j,
        JCtx(seed=jnp.uint32(7)), active=jnp.asarray(act), page_tables=jt,
        page_lens=jlens)
    lt, _, at = tlm.decode_step(
        params_t, ct, torch.from_numpy(tok).long(),
        torch.from_numpy(ntok).long(), cfg_t, TCtx(seed=7),
        active=torch.from_numpy(act), page_tables=tt, page_lens=tlens)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(lj, -1)))
    np.testing.assert_allclose(float(at["energy_pj"]), float(aj["energy_pj"]),
                               rtol=1e-5)


def test_greedy_token_streams_identical(served):
    ej, rj, _, _ = served["jax"]
    for tag in ("torch", "replay"):
        et, rt, _, _ = served[tag]
        assert et.cfg.placement_plan() == ej.cfg.placement_plan()
        assert [r.rid for r in rt] == [r.rid for r in rj] == list(range(5))
        for a, b in zip(rj, rt):
            np.testing.assert_array_equal(b.tokens, a.tokens,
                                          err_msg=f"{tag} rid {a.rid}")
            assert b.done_reason == a.done_reason and b.steps == a.steps


def test_energy_ledgers_match_on_the_same_dac_levels(served):
    """Replaying the JAX run's DAC levels, the port's ledgers (per request,
    idle, total, per corner) agree with JAX's within rtol 1e-5 and are
    conserved."""
    ej, rj, _, _ = served["jax"]
    et, rt, _, _ = served["replay"]
    for a, b in zip(rj, rt):
        np.testing.assert_allclose(b.energy_pj, a.energy_pj, rtol=1e-5)
        np.testing.assert_allclose(b.prefill_energy_pj, a.prefill_energy_pj,
                                   rtol=1e-5)
    np.testing.assert_allclose(et.total_energy_pj, ej.total_energy_pj,
                               rtol=1e-5)
    np.testing.assert_allclose(et.idle_energy_pj, ej.idle_energy_pj,
                               rtol=1e-5)
    mj, mt = ej.metrics()["corner_energy_pj"], et.metrics()["corner_energy_pj"]
    assert set(mt) == set(mj) == {"pcm", "rram"}
    for name in mt:
        np.testing.assert_allclose(mt[name], mj[name], rtol=1e-5,
                                   err_msg=name)
        assert mt[name] > 0
    np.testing.assert_allclose(sum(mt.values()), et.total_energy_pj,
                               rtol=1e-6)
    assert et.energy_conserved(rt) and ej.energy_conserved(rj)


def test_free_running_ledgers_differ_only_where_dac_levels_flip(served):
    """On its own the port computes every projection input to float32
    order, and a DAC level at a rounding tie (x / scale = k + 0.5 within
    float32 order) can round the other way; the flip then propagates
    through the layers and, through the K/V cache, into later steps
    (ROADMAP Queue 3).  Every step whose levels all agree books the same
    per-corner energy within rtol 1e-5, and the first levels of the run
    that differ sit at a tie."""
    _, _, lv_j, st_j = served["jax"]
    et, rt, lv_t, st_t = served["torch"]
    per_step = 7 * et.cfg.num_layers + 1
    assert len(st_t) == len(st_j) and len(lv_t) == len(lv_j) == \
        per_step * len(st_j)
    first = True
    for step, (ej_, et_) in enumerate(zip(st_j, st_t)):
        calls = range(step * per_step, (step + 1) * per_step)
        diff = [c for c in calls
                if not np.array_equal(lv_j[c][0], lv_t[c][0])]
        if not diff:
            assert set(et_) == set(ej_) == {"pcm", "rram"}
            for name in ej_:
                np.testing.assert_allclose(et_[name], ej_[name], rtol=1e-5,
                                           err_msg=f"step {step} {name}")
            continue
        if first:
            lj, sj, xj = lv_j[diff[0]]
            lt, _, _ = lv_t[diff[0]]
            xs = np.abs(xj / sj)
            ties = np.abs(xs - np.floor(xs) - 0.5)[lj != lt]
            assert ties.max() < 1e-4, (step, diff[0], ties.max())
            first = False
    assert et.energy_conserved(rt)


