"""Port parity of the MoE slice end to end: moonshot-v1-16b-a3b smoke (2
layers, 4 experts top-4, MHA) served by the port's engine on the "mixed"
placement (attention analog on PCM, the experts technique A on RRAM, the
routers analog on SRAM, the unembed analog on PCM) and on the single
analog corner (digital routers), paged KV, chunked prefill, per-row DAC
scale, frozen noise, against the JAX package's engine on identical weights.

Tolerances: chunk-step and decode-step logits within 1e-4 absolute
(float32); greedy token streams identical; total, per-request, idle and
per-corner energy within rtol 1e-5 on a run that replays the JAX run's DAC
levels (an activation level at a float32 rounding tie can round the other
way and move a step's ledger; the free-running run is checked to differ
only in steps whose levels flipped, from a first flip at a tie).  The JAX
engine runs op by op so its levels can be recorded.
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
from repro.serve.spec import ServeSpec as JSpec
from repro_torch.core import emt_linear as tel
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx
from repro_torch.serve.engine import GenRequest as TReq
from repro_torch.serve.engine import ServingEngine as TEng
from repro_torch.serve.kv_pool import PagedKV as TKV
from repro_torch.serve.spec import ServeSpec as TSpec

ARCH = "moonshot-v1-16b-a3b"
ENGINE = dict(batch_size=3, max_len=40, seed=7, paged=True, block_size=8,
              prefill_chunk=8)
PLACEMENTS = {"mixed": dict(placement="mixed"), "analog": dict(mode="analog")}
CORNERS = {"mixed": {"pcm", "rram", "sram_digital"}, "analog": {"analog"}}


def _spec(mod, which):
    return mod(arch=ARCH, a_per_row=True, frozen_noise=True, smoke=True,
               **PLACEMENTS[which])


@pytest.fixture(scope="module", params=sorted(PLACEMENTS))
def models(request):
    which = request.param
    cfg_j = _spec(JSpec, which).build_config()
    params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
    cfg_t = _spec(TSpec, which).build_config()
    params_t = tlm.load_jax_arrays(_tree_to_arrays(params_j), cfg_t,
                                   device="cpu")
    return which, cfg_j, params_j, cfg_t, params_t


def _requests(Req):
    rng = np.random.default_rng(4)
    return [Req(prompt=rng.integers(0, 512, plen).astype(np.int32),
                max_new=4 + i, seed=100 + i)
            for i, plen in enumerate([11, 3, 17, 6])]


@contextlib.contextmanager
def _patched(obj, name, fn):
    orig = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def _run(eng, Req, levels, steps, replay=None):
    """Serve the requests on `eng`, appending every DAC-quantized
    projection's (levels, scale, input) to `levels` and every step's
    per-corner energy to `steps`; with `replay` the port's quantizer
    returns those levels and scales, in call order, instead of its own."""
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
    """The JAX engine (op by op) and the port's engine, on its own and
    replaying the JAX run's DAC levels."""
    which, cfg_j, params_j, cfg_t, params_t = models
    out = {}
    with jax.disable_jit():
        ej = JEng(cfg_j, params_j, fresh_noise=False, **ENGINE)
        lv, st = [], []
        out["jax"] = (ej, _run(ej, JReq, lv, st), lv, st)
    for tag, replay in (("torch", None),
                        ("replay", [(a, b) for a, b, _ in lv])):
        et = TEng(cfg_t, params_t, fresh_noise=False, device="cpu", **ENGINE)
        lv_t, st_t = [], []
        out[tag] = (et, _run(et, TReq, lv_t, st_t, replay), lv_t, st_t)
    return which, out


def test_chunk_and_decode_logits_match(models):
    """One chunk step (a row of padding lanes, so the zero lanes route and
    take expert capacity) and one decode step: logits within 1e-4, the
    per-corner ledgers within rtol 1e-5."""
    which, cfg_j, params_j, cfg_t, params_t = models
    B, L, bs = 3, 40, 8
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
    assert set(at["corners"]) == set(aj["corners"]) == CORNERS[which]
    for name in CORNERS[which]:
        np.testing.assert_allclose(float(at["corners"][name]["energy_pj"]),
                                   float(aj["corners"][name]["energy_pj"]),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(at["aux_loss"]), float(aj["aux_loss"]),
                               rtol=1e-6)
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
    for key in ("energy_pj", "reads", "reg"):
        np.testing.assert_allclose(float(at[key]), float(aj[key]),
                                   rtol=1e-5, err_msg=key)


def test_greedy_token_streams_identical(served):
    which, out = served
    ej, rj, _, _ = out["jax"]
    assert ej.chunked
    for tag in ("torch", "replay"):
        et, rt, _, _ = out[tag]
        assert et.chunked
        assert et.cfg.placement_plan() == ej.cfg.placement_plan()
        assert [r.rid for r in rt] == [r.rid for r in rj] == list(range(4))
        for a, b in zip(rj, rt):
            np.testing.assert_array_equal(b.tokens, a.tokens,
                                          err_msg=f"{which} {tag} rid {a.rid}")
            assert b.done_reason == a.done_reason and b.steps == a.steps


def test_energy_ledgers_match_on_the_same_dac_levels(served):
    """Replaying the JAX run's DAC levels, the port's ledgers (per request,
    idle, total, per corner) agree with JAX's within rtol 1e-5 and are
    conserved."""
    which, out = served
    ej, rj, _, _ = out["jax"]
    et, rt, _, _ = out["replay"]
    for a, b in zip(rj, rt):
        np.testing.assert_allclose(b.energy_pj, a.energy_pj, rtol=1e-5)
        np.testing.assert_allclose(b.prefill_energy_pj, a.prefill_energy_pj,
                                   rtol=1e-5)
    np.testing.assert_allclose(et.total_energy_pj, ej.total_energy_pj,
                               rtol=1e-5)
    np.testing.assert_allclose(et.idle_energy_pj, ej.idle_energy_pj,
                               rtol=1e-5)
    mj, mt = ej.metrics()["corner_energy_pj"], et.metrics()["corner_energy_pj"]
    assert set(mt) == set(mj) == CORNERS[which]
    for name in mt:
        np.testing.assert_allclose(mt[name], mj[name], rtol=1e-5,
                                   err_msg=name)
        assert mt[name] > 0
    np.testing.assert_allclose(sum(mt.values()), et.total_energy_pj,
                               rtol=1e-6)
    assert et.energy_conserved(rt) and ej.energy_conserved(rj)


def test_free_running_ledgers_differ_only_where_dac_levels_flip(served):
    """On its own the port's steps book JAX's per-corner energy within rtol
    1e-5 wherever every DAC level of the step agrees, and the first levels
    of the run that differ sit at a rounding tie."""
    which, out = served
    _, _, lv_j, st_j = out["jax"]
    et, rt, lv_t, st_t = out["torch"]
    routers = et.cfg.num_layers if which == "mixed" else 0
    per_step = 4 * et.cfg.num_layers + routers + 1
    assert len(st_t) == len(st_j) and len(lv_t) == len(lv_j) == \
        per_step * len(st_j)
    first = True
    for step, (ej_, et_) in enumerate(zip(st_j, st_t)):
        calls = range(step * per_step, (step + 1) * per_step)
        diff = [c for c in calls
                if not np.array_equal(lv_j[c][0], lv_t[c][0])]
        if not diff:
            assert set(et_) == set(ej_) == CORNERS[which]
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
