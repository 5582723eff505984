"""Port parity of heterogeneous speculative decoding: the eight tests of
``tests/test_speculative.py`` held against JAX's ``SpeculativeEngine`` on
the same weights (the numpy bridge), plus the spec and the launcher.

The fixture is JAX's: the smoke gemma3-1b stack, 2 all-global layers,
batch 2, max_len 32, k = 3, frozen noise; the analog target on PCM with
per-row DAC scales, the draft on ``sram_digital`` (amplitude 0).

* Tokens: the port's SpeculativeEngine gives JAX's SpeculativeEngine's
  tokens, done reasons, accept histogram and per-request proposal counts,
  and its own plain engine's tokens (greedy identity).
* Ledgers: within rtol 1e-5 of JAX's on a run that replays JAX's DAC
  levels (recorded from JAX's jitted steps by ordered host callbacks; the
  pattern of tests/test_torch_ring.py: free-running, a level at a float32
  rounding tie may round the other way and move a ledger by ~1e-5,
  ROADMAP Queue 3); the three conservation invariants (per-request + idle
  == total, corners sum to the total, draft per-request + draft idle ==
  draft total == the sram_digital corner) at rtol 1e-6, JAX's gate.
* Rejected drafts from perturbed draft params, staggered admission, the
  paged layout's block hygiene, cancel mid-decode with the shadow cache
  zeroed, and JAX's guards with its messages.
"""
import contextlib
import dataclasses
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.configs import get_config as jget
from repro.core import emt_linear as jel
from repro.core.emt_linear import IDEAL as J_IDEAL
from repro.core.placement import emt_for_corner as j_corner
from repro.models import lm as jlm
from repro.nn.param import init_params
from repro.serve.engine import GenRequest as JReq
from repro.serve.engine import ServingEngine as JEng
from repro.serve.speculative import SpeculativeEngine as JSpec
from repro_torch.configs import get_config as tget
from repro_torch.core import emt_linear as tel
from repro_torch.core.emt_linear import IDEAL as T_IDEAL
from repro_torch.core.placement import emt_for_corner as t_corner
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import GenRequest as TReq
from repro_torch.serve.engine import ServingEngine as TEng
from repro_torch.serve.speculative import SpeculativeEngine as TSpec

K = 3


def _base_cfgs(mode):
    cj = jget("gemma3-1b", smoke=True, emt_mode=mode).replace(
        dtype=jnp.float32, num_layers=2, layer_pattern=("attn",),
        sliding_window=0, paged_attn_impl="ref")
    ct = tget("gemma3-1b", smoke=True, emt_mode=mode).replace(
        dtype=torch.float32, num_layers=2, layer_pattern=("attn",),
        sliding_window=0)
    return cj, ct


def _pcm_cfgs():
    cj, ct = _base_cfgs("analog")
    tj, tt = j_corner("pcm"), t_corner("pcm")
    tj = tj.replace(quant=dataclasses.replace(tj.quant, a_per_row=True))
    tt = tt.replace(quant=dataclasses.replace(tt.quant, a_per_row=True))
    return cj.replace(emt=tj), ct.replace(emt=tt)


def _params(cj, ct, seed):
    pj = init_params(jlm.specs(cj), jax.random.PRNGKey(seed))
    pt = tlm.load_jax_arrays(_tree_to_arrays(pj), ct, device="cpu")
    return pj, pt


def _specs(lens=((8, 16), (5, 10)), base_seed=0):
    out = []
    for i, (plen, max_new) in enumerate(lens):
        rng = np.random.default_rng(base_seed + i)
        out.append(dict(prompt=rng.integers(0, 512, plen).astype(np.int32),
                        max_new=max_new))
    return out


def _mk(cls, cfg, params, **kw):
    kw.setdefault("spec_k", K)
    if cls is TSpec:
        kw["device"] = "cpu"
    return cls(cfg, params, batch_size=2, max_len=32, seed=7,
               fresh_noise=False, **kw)


@contextlib.contextmanager
def _jax_levels(out):
    """Record every projection's DAC (levels, scale) of JAX's jitted steps
    in `out`, in program order (ordered host callbacks; call
    jax.effects_barrier() before reading)."""
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
    finally:
        jel.quant_levels = orig


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


def _same_tokens(ra, rb):
    assert [r.rid for r in ra] == [r.rid for r in rb]
    for a, b in zip(ra, rb):
        np.testing.assert_array_equal(b.tokens, a.tokens,
                                      err_msg=f"rid {a.rid}")
        assert b.done_reason == a.done_reason


def _same_spec_stats(ej, rj, et, rt):
    assert et.accept_len_hist.tolist() == ej.accept_len_hist.tolist()
    assert (et.spec_rounds, et.spec_proposed_total, et.spec_accepted_total,
            et.draft_steps) == (ej.spec_rounds, ej.spec_proposed_total,
                                ej.spec_accepted_total, ej.draft_steps)
    for a, b in zip(rj, rt):
        assert (b.spec_proposed, b.spec_accepted, b.steps) == (
            a.spec_proposed, a.spec_accepted, a.steps)


def _conserved(eng, results):
    """JAX's _assert_conservation on the port's engine."""
    assert np.isclose(sum(r.energy_pj for r in results)
                      + eng.idle_energy_pj, eng.total_energy_pj, rtol=1e-6)
    assert np.isclose(sum(eng.corner_energy_pj.values()),
                      eng.total_energy_pj, rtol=1e-6)
    assert np.isclose(sum(r.draft_energy_pj for r in results)
                      + eng.draft_idle_energy_pj,
                      eng.draft_total_energy_pj, rtol=1e-6)
    assert eng.draft_total_energy_pj <= eng.total_energy_pj
    assert np.isclose(eng.corner_energy_pj.get("sram_digital", 0.0),
                      eng.draft_total_energy_pj, rtol=1e-6)


def _same_ledgers(ej, rj, et, rt):
    for a, b in zip(rj, rt):
        for k in ("energy_pj", "prefill_energy_pj", "draft_energy_pj"):
            np.testing.assert_allclose(getattr(b, k), getattr(a, k),
                                       rtol=1e-5, err_msg=k)
    mj, mt = ej.metrics(), et.metrics()
    for k in ("total_energy_pj", "idle_energy_pj", "draft_total_energy_pj",
              "draft_idle_energy_pj"):
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-5, err_msg=k)
    assert set(mt["corner_energy_pj"]) == set(mj["corner_energy_pj"])
    for k, v in mj["corner_energy_pj"].items():
        np.testing.assert_allclose(mt["corner_energy_pj"][k], v, rtol=1e-5)
    assert mt["kv_reads_total"] == mj["kv_reads_total"]
    for k in ("steps", "peak_concurrent", "prefill_tokens_total"):
        assert mt[k] == mj[k], k


@pytest.fixture(scope="module")
def pcm():
    """JAX's fixture on both packages: the plain and the speculative
    engines, JAX's speculative run with its DAC levels recorded, the
    port's free-running and replaying them."""
    cj, ct = _pcm_cfgs()
    pj, pt = _params(cj, ct, 0)
    base_j = JEng(cj, pj, batch_size=2, max_len=32, seed=7,
                  fresh_noise=False)
    base_t = TEng(ct, pt, batch_size=2, max_len=32, seed=7,
                  fresh_noise=False, device="cpu")
    lv = []
    with _jax_levels(lv):
        spec_j = _mk(JSpec, cj, pj)
        spec_res_j = spec_j.serve([JReq(**s) for s in _specs()])
        jax.effects_barrier()
    spec_t = _mk(TSpec, ct, pt)
    replay = _mk(TSpec, ct, pt)
    with _levels(tel, [], list(lv)):
        replay_res = replay.serve([TReq(**s) for s in _specs()])
    out = dict(cj=cj, ct=ct, pj=pj, pt=pt, base_j=base_j, base_t=base_t,
               spec_j=spec_j, spec_t=spec_t,
               base_res_j=base_j.serve([JReq(**s) for s in _specs()]),
               base_res_t=base_t.serve([TReq(**s) for s in _specs()]),
               spec_res_j=spec_res_j,
               spec_res_t=spec_t.serve([TReq(**s) for s in _specs()]),
               rec=(spec_j, spec_res_j), replay=(replay, replay_res))
    out["history"] = list(out["spec_res_t"])
    return out


def test_token_identity_analog_per_row(pcm):
    """The port's speculative tokens are JAX's speculative tokens and the
    plain engines' (both packages); the accept statistics are JAX's."""
    _same_tokens(pcm["base_res_j"], pcm["base_res_t"])
    _same_tokens(pcm["spec_res_j"], pcm["spec_res_t"])
    _same_tokens(pcm["base_res_t"], pcm["spec_res_t"])
    spec = pcm["spec_t"]
    _same_spec_stats(pcm["spec_j"], pcm["spec_res_j"], spec,
                     pcm["spec_res_t"])
    assert spec.spec_rounds > 0
    assert 0.0 < spec.accept_rate <= 1.0
    assert spec.accept_len_hist.sum() == spec.spec_rounds
    for r in pcm["spec_res_t"]:
        assert r.spec_proposed >= r.spec_accepted >= 0
        assert r.draft_energy_pj > 0.0


def test_two_placement_energy_conservation(pcm):
    """One ledger across both placements, the draft split conserved; on
    JAX's replayed levels every ledger within rtol 1e-5 of JAX's; plain
    engines bill no draft."""
    spec = pcm["spec_t"]
    assert set(spec.corner_energy_pj) >= {"pcm", "sram_digital"}
    assert spec.corner_energy_pj["pcm"] > 0.0
    assert spec.corner_energy_pj["sram_digital"] > 0.0
    _conserved(spec, pcm["spec_res_t"])
    (ej, rj), (et, rt) = pcm["rec"], pcm["replay"]
    _same_tokens(rj, rt)
    _same_ledgers(ej, rj, et, rt)
    _conserved(et, rt)
    base = pcm["base_t"]
    assert "sram_digital" not in base.corner_energy_pj
    assert all(r.draft_energy_pj == 0.0 and r.spec_proposed == 0
               for r in pcm["base_res_t"])


def test_token_identity_staggered_admission(pcm):
    """Mixed rounds (one slot streaming prompt lanes through the verify
    chunk while the other speculates) and k_eff clamping: JAX's tokens, and
    the solo plain engine's for the first request."""
    lens = ((6, 12), (9, 14))
    solo = pcm["base_t"].serve([TReq(**s) for s in
                                _specs(lens[:1], base_seed=50)])
    stag_t = pcm["spec_t"].serve([TReq(**s) for s in _specs(lens, 50)],
                                 stagger=2)
    stag_j = pcm["spec_j"].serve([JReq(**s) for s in _specs(lens, 50)],
                                 stagger=2)
    pcm["history"].extend(stag_t)
    np.testing.assert_array_equal(solo[0].tokens, stag_t[0].tokens)
    _same_tokens(stag_j, stag_t)
    _conserved(pcm["spec_t"], pcm["history"])


def _perturb(arr):
    a = np.asarray(arr)
    if a.dtype != np.float32:
        return a
    return a * (1.0 + 0.05 * np.sin(np.arange(a.size, dtype=np.float32)
                                    .reshape(a.shape)))


def test_rejected_drafts_keep_identity(pcm):
    """A perturbed draft model (JAX's perturbation, on both packages)
    proposes junk some of the time: the accept rate drops below 1, the
    accept histogram is JAX's, every committed token is still the
    target's."""
    cj, ct, pj = pcm["cj"], pcm["ct"], pcm["pj"]
    bad_j = jax.tree.map(lambda x: jnp.asarray(_perturb(x)), pj)
    arrays = {k: _perturb(v) for k, v in _tree_to_arrays(pj).items()}
    bad_t = tlm.load_jax_arrays(arrays, ct, device="cpu")
    ej = _mk(JSpec, cj, pj, draft_params=bad_j)
    et = _mk(TSpec, ct, pcm["pt"], draft_params=bad_t)
    rj = ej.serve([JReq(**s) for s in _specs()])
    rt = et.serve([TReq(**s) for s in _specs()])
    assert et.accept_rate < 1.0
    _same_tokens(pcm["base_res_t"], rt)
    _same_tokens(rj, rt)
    _same_spec_stats(ej, rj, et, rt)
    _conserved(et, rt)


def test_token_identity_ideal_mode():
    """Ideal params carry no rho_raw, so the draft is an ideal placement:
    the same computation as the target, every proposal accepted."""
    cj, ct = _base_cfgs("ideal")
    pj, pt = _params(cj, ct, 1)
    base = TEng(ct, pt, batch_size=2, max_len=32, seed=7, fresh_noise=False,
                device="cpu")
    et = _mk(TSpec, ct, pt, draft_placement=T_IDEAL)
    ej = _mk(JSpec, cj, pj, draft_placement=J_IDEAL)
    rb = base.serve([TReq(**s) for s in _specs()])
    rt = et.serve([TReq(**s) for s in _specs()])
    rj = ej.serve([JReq(**s) for s in _specs()])
    _same_tokens(rb, rt)
    _same_tokens(rj, rt)
    assert et.spec_proposed_total > 0
    assert et.accept_rate == 1.0 == ej.accept_rate


def test_paged_speculative_identity_and_hygiene(pcm):
    """The paged target (blocks of 4): the plain engine's tokens, and JAX's
    speculative tokens and per-request proposals (JAX's paged and
    contiguous speculation agree, tests/test_speculative.py); verify
    writes stay inside the admission-time reservation and the pool comes
    back clean."""
    et = _mk(TSpec, pcm["ct"], pcm["pt"], paged=True, block_size=4)
    rt = et.serve([TReq(**s) for s in _specs()])
    _same_tokens(pcm["base_res_t"], rt)
    _same_tokens(pcm["spec_res_j"], rt)
    for a, b in zip(pcm["spec_res_j"], rt):
        assert (b.spec_proposed, b.spec_accepted, b.steps) == (
            a.spec_proposed, a.spec_accepted, a.steps)
    _conserved(et, rt)
    et.kv.check()
    assert et.kv.pool_g.num_owned == 0


def _cancel_run(spec, req_cls):
    reqs = [req_cls(**s) for s in _specs(((8, 16), (8, 16)), base_seed=80)]
    rids = [spec.submit(r) for r in reqs]
    results = []
    for _ in range(16):
        results += spec.step()
        if any(len(s.generated) >= 3 for _, s in
               spec.scheduler.active_slots()):
            break
    cancelled = spec.cancel(rids[0])
    return reqs, cancelled, results + [cancelled] + spec.drain()


def test_cancel_mid_decode_partials_and_draft_hygiene(pcm):
    """Cancel after 3 generated tokens: JAX's partial, conservation in the
    scenario-delta form, and the shadow cache all zeros after retirement."""
    spec = pcm["spec_t"]
    snap = (spec.total_energy_pj, spec.idle_energy_pj)
    reqs, cancelled, results = _cancel_run(spec, TReq)
    _, cancelled_j, results_j = _cancel_run(pcm["spec_j"], JReq)
    assert cancelled is not None and cancelled.done_reason == "cancelled"
    assert 0 < len(cancelled.tokens) < reqs[0].max_new
    np.testing.assert_array_equal(cancelled.tokens, cancelled_j.tokens)
    _same_tokens(sorted(results_j, key=lambda r: r.rid),
                 sorted(results, key=lambda r: r.rid))
    pcm["history"].extend(results)
    d_total = spec.total_energy_pj - snap[0]
    d_idle = spec.idle_energy_pj - snap[1]
    assert np.isclose(sum(r.energy_pj for r in results) + d_idle, d_total,
                      rtol=1e-6)
    for blk in spec.draft_cache.values():
        for t in blk.values():
            assert float(t.abs().max()) == 0.0


def test_guards():
    """JAX's guards, with JAX's messages: ring stacks, spec_k, the prefix
    cache, the legacy prefill, temperature; and shards."""
    cj, ct = _base_cfgs("ideal")
    _, pt = _params(cj, ct, 2)
    ring = tget("gemma3-1b", smoke=True).replace(dtype=torch.float32,
                                                 num_layers=2)
    assert "local" in ring.blocks() and ring.sliding_window
    kw = dict(batch_size=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="all-global"):
        TSpec(ring, pt, **kw)
    with pytest.raises(ValueError, match="spec_k"):
        TSpec(ct, pt, spec_k=0, **kw)
    with pytest.raises(ValueError, match="prefix_cache"):
        TSpec(ct, pt, paged=True, block_size=4, prefix_cache=True, **kw)
    with pytest.raises(ValueError, match="chunked"):
        TSpec(ct, pt, chunked_prefill=False, **kw)
    with pytest.raises(ValueError, match="n_shards must be 1"):
        TSpec(ct, pt, n_shards=2, **kw)
    eng = TSpec(ct, pt, **kw)
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit(TReq(prompt=np.arange(4, dtype=np.int32), max_new=4,
                        temperature=0.7))


def test_serve_spec_builds_and_serves_speculation():
    """ServeSpec(draft_placement=...) builds the speculative engine and
    serves, as JAX's does, with JAX's tokens and accept statistics on the
    same weights."""
    from repro.serve.spec import ServeSpec as JS
    from repro_torch.serve.spec import ServeSpec as TS
    kw = dict(all_global=True, a_per_row=True, frozen_noise=True,
              draft_placement="sram_digital", spec_k=2, max_len=32,
              batch_size=2, model_overrides={"num_layers": 2})
    cj, ct = JS(**kw).build_config(), TS(**kw).build_config()
    pj, pt = _params(cj, ct, 0)
    ej = JS(**kw).build_engine(cj, pj)
    et = TS(**kw).build_engine(ct, pt, torch_device="cpu")
    assert isinstance(et, TSpec) and et.spec_k == 2
    rj = ej.serve([JReq(**s) for s in _specs(((7, 6), (12, 5)), 9)],
                  stagger=1)
    rt = et.serve([TReq(**s) for s in _specs(((7, 6), (12, 5)), 9)],
                  stagger=1)
    _same_tokens(rj, rt)
    _same_spec_stats(ej, rj, et, rt)
    _conserved(et, rt)


def test_launcher_prints_the_speculation_line_of_jax(monkeypatch):
    """``launch.serve --draft-placement sram_digital`` on the CPU: the
    coercion note and JAX's speculation line with JAX's accept rate and
    histogram, on JAX's launcher weights carried through the bridge."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    argv = ["--draft-placement", "sram_digital", "--spec-k", "2", "--batch",
            "2", "--requests", "2", "--prompt-len", "6", "--max-new", "4",
            "--frozen-noise"]
    args = tserve._parser().parse_args(argv)
    cfg_j = jserve.spec_from_args(args).build_config()
    arrays = _tree_to_arrays(init_params(jlm.specs(cfg_j),
                                         jax.random.PRNGKey(0)))
    monkeypatch.setattr(tserve.lm, "init_model_params",
                        lambda cfg, seed, device: tlm.load_jax_arrays(
                            arrays, cfg, device=device))
    outs = []
    for run in (lambda: jserve.main(),
                lambda: tserve.main(argv, torch_device="cpu")):
        buf = io.StringIO()
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        with contextlib.redirect_stdout(buf):
            run()
        outs.append(buf.getvalue())
    pat = r"speculation: accept rate ([\d.]+), accepted-length histogram " \
          r"(\[[\d, ]+\]), draft energy ([\d.]+) uJ \(([\d.]+)% of total\)"
    mj, mt = re.search(pat, outs[0]), re.search(pat, outs[1])
    assert mj and mt, outs[1]
    assert mt.group(1, 2) == mj.group(1, 2)
    np.testing.assert_allclose(float(mt.group(3)), float(mj.group(3)),
                               rtol=1e-2)
    for line in ("speculative decoding: coerced attention stack to "
                 "all-global", "speculative decoding: draft on sram_digital"
                 ", k=2"):
        assert line in outs[0] and line in outs[1]


def test_streaming_server_and_energy_budget_with_speculation(pcm):
    """StreamingServer serves a speculative engine (several tokens a step
    streamed in order, the results those of engine.serve); and the
    control plane counts the draft share against a request's uJ budget,
    shedding at JAX's token as JAX's speculative engine does."""
    from repro.serve.control import EnergyBudgetController as JCtl
    from repro_torch.serve.control import EnergyBudgetController as TCtl
    from repro_torch.serve.server import StreamingServer
    eng = _mk(TSpec, pcm["ct"], pcm["pt"])
    with StreamingServer(eng, max_pending=4) as srv:
        handles = [srv.submit(TReq(**s)) for s in _specs()]
        streamed = [list(h.tokens(timeout=120)) for h in handles]
        results = [h.result(timeout=120) for h in handles]
    for toks, r, want in zip(streamed, results, pcm["spec_res_t"]):
        np.testing.assert_array_equal(np.asarray(toks, np.int32), r.tokens)
        np.testing.assert_array_equal(r.tokens, want.tokens)
    budget = 0.5 * pcm["spec_res_t"][0].energy_pj * 1e-6
    runs = []
    for cls, req, ctl, cfg, params in (
            (JSpec, JReq, JCtl, pcm["cj"], pcm["pj"]),
            (TSpec, TReq, TCtl, pcm["ct"], pcm["pt"])):
        eng = _mk(cls, cfg, params, controller=ctl())
        res = eng.serve([req(**s, energy_budget_uj=budget)
                         for s in _specs()])
        runs.append(res)
        if cls is TSpec:
            _conserved(eng, res)
            assert eng.controller.shed >= 1
    _same_tokens(*runs)
    assert runs[1][0].done_reason == "energy_budget"
    assert runs[1][0].draft_energy_pj > 0
