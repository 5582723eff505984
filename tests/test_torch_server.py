"""Port parity of the streaming front end and the energy control plane
(``repro_torch.serve.server``, ``repro_torch.serve.control`` and the
engine's ``on_token`` / ``controller`` hooks), on the cases of
``tests/test_server.py`` and ``tests/test_control.py``.

Shrunk gemma3-1b (2 layers, all-global, per-row DAC scale, frozen noise),
weights from JAX's init through the numpy bridge.  The deterministic
engine-level cases run the same script on JAX's engine and the port's:
the ``on_token`` streams (tokens and the step each was emitted at),
cancellations, sheds and deferred admissions must be JAX's, energies
within rtol 1e-5.  The threaded server cases run on the port; the tokens
they stream must equal JAX's engine on the same requests (with the
per-row DAC and frozen noise, a request's tokens do not depend on its
co-tenants or on when it is admitted).
"""
import jax
import numpy as np
import pytest

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.models import lm as jlm
from repro.nn.param import init_params
from repro.serve.control import EnergyBudgetController as JCtl
from repro.serve.engine import GenRequest as JReq
from repro.serve.engine import ServingEngine as JEng
from repro.serve.scheduler import RejectedError as JRejected
from repro.serve.spec import ServeSpec as JSpec
from repro_torch.models import lm as tlm
from repro_torch.serve.control import EnergyBudgetController as TCtl
from repro_torch.serve.engine import GenRequest as TReq
from repro_torch.serve.engine import ServingEngine as TEng
from repro_torch.serve.scheduler import RejectedError
from repro_torch.serve.server import StreamingServer
from repro_torch.serve.spec import ServeSpec as TSpec

PAGED = dict(batch_size=2, max_len=32, seed=7, fresh_noise=False,
             paged=True, block_size=8)
CONTIG = dict(batch_size=2, max_len=32, seed=7, fresh_noise=False)


def _models(device=None):
    kw = dict(arch="gemma3-1b", mode="analog", smoke=True, all_global=True,
              a_per_row=True, device=device,
              model_overrides={"num_layers": 2})
    cfg_j = JSpec(**kw).build_config()
    params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
    cfg_t = TSpec(**kw).build_config()
    params_t = tlm.load_jax_arrays(_tree_to_arrays(params_j), cfg_t,
                                   device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def pcm():
    """The control plane's setting: every layer on the PCM corner."""
    cfg_j, params_j, cfg_t, params_t = _models("pcm")
    sides = {"jax": (JEng(cfg_j, params_j, **CONTIG), JReq, JCtl),
             "torch": (TEng(cfg_t, params_t, device="cpu", **CONTIG), TReq,
                       TCtl)}
    free = {}
    for name, (eng, Req, _) in sides.items():
        free[name] = eng.serve([_req(Req, 0)])[0]
        assert free[name].done_reason == "max_new"
    np.testing.assert_array_equal(free["torch"].tokens, free["jax"].tokens)
    np.testing.assert_allclose(free["torch"].energy_pj,
                               free["jax"].energy_pj, rtol=1e-5)
    return sides, free


def _req(Req, seed=0, plen=8, max_new=12, **kw):
    rng = np.random.default_rng(seed)
    return Req(prompt=rng.integers(0, 512, plen).astype(np.int32),
               max_new=max_new, **kw)


def _mk(Req, rng, n, **kw):
    return Req(prompt=rng.integers(0, 512, n).astype(np.int32), **kw)


def _engines(models, **kw):
    cfg_j, params_j, cfg_t, params_t = models
    return {"jax": (JEng(cfg_j, params_j, **dict(PAGED, **kw)), JReq),
            "torch": (TEng(cfg_t, params_t, device="cpu",
                           **dict(PAGED, **kw)), TReq)}


# -- validation and backpressure ----------------------------------------------

def test_validate_raises_valueerror_not_assert(models):
    """Every bad request is a ValueError with JAX's message, before it
    reaches the queue; a request no empty pool can hold is refused up
    front."""
    msgs = {}
    for name, (eng, Req) in _engines(models).items():
        rng = np.random.default_rng(0)
        ok = _mk(Req, rng, 6, max_new=4)
        bad = [Req(prompt=np.zeros(0, np.int32)),
               _mk(Req, rng, eng.max_len + 1),
               Req(prompt=ok.prompt, max_new=0),
               Req(prompt=ok.prompt, temperature=-0.5),
               Req(prompt=ok.prompt, top_p=-0.1),
               Req(prompt=ok.prompt, top_k=-1),
               Req(prompt=ok.prompt, energy_budget_uj=0.0)]
        out = []
        for req in bad:
            with pytest.raises(ValueError) as err:
                eng.submit(req)
            out.append(str(err.value))
        assert eng.scheduler.pending == 0
        tiny = _engines(models, batch_size=1, num_blocks=2)[name][0]
        with pytest.raises(ValueError) as err:
            tiny.validate(_mk(Req, rng, 8, max_new=24))
        msgs[name] = out + [str(err.value)]
    assert msgs["torch"] == msgs["jax"]


def test_engine_fifo_backpressure(models):
    for name, (eng, Req) in _engines(models, batch_size=1,
                                     max_pending=1).items():
        rng = np.random.default_rng(1)
        eng.submit(_mk(Req, rng, 4, max_new=2))
        exc = JRejected if name == "jax" else RejectedError
        with pytest.raises(exc):
            eng.submit(_mk(Req, rng, 4, max_new=2))


def test_drain_raises_on_stuck_engine(models):
    """A request whose blocks a leaked owner holds fails drain() with the
    stuck state instead of spinning."""
    cfg_t, params_t = models[2:]
    eng = TEng(cfg_t, params_t, device="cpu", **dict(PAGED, batch_size=1,
                                                     num_blocks=4))
    assert eng.kv.pool_g.alloc(owner=999, blocks=3) is not None
    eng.submit(_mk(TReq, np.random.default_rng(5), 8, max_new=16))
    with pytest.raises(RuntimeError, match="no progress"):
        eng.drain(stall_limit=4)


# -- streaming (engine level, deterministic) ----------------------------------

def test_on_token_streams_before_cotenant_retires(models):
    """on_token fires at sample time: a later request's first token is
    emitted before the first request retires, the stream equals each
    result, and the (step, token) streams are JAX's."""
    streams = {}
    for name, (eng, Req) in _engines(models).items():
        rng = np.random.default_rng(3)
        emitted = {}
        eng.on_token = lambda rid, tok, e=eng, out=emitted: \
            out.setdefault(rid, []).append((e._steps, tok))
        rid0 = eng.submit(_mk(Req, rng, 6, max_new=10, seed=1))
        rid1 = eng.submit(_mk(Req, rng, 4, max_new=6, seed=2))
        results = {}
        while eng.scheduler.busy:
            for res in eng.step():
                results[res.rid] = (res, eng._steps)
        assert emitted[rid1][0][0] < results[rid0][1]
        for rid in (rid0, rid1):
            np.testing.assert_array_equal(
                np.asarray([t for _, t in emitted[rid]], np.int32),
                results[rid][0].tokens)
        streams[name] = {rid: [(s, int(t)) for s, t in v]
                         for rid, v in emitted.items()}
    assert streams["torch"] == streams["jax"]


def test_engine_cancel_queued_and_mid_flight(models):
    """Cancel a queued request (empty result) and a decoding one (partial
    tokens, energy billed); a second cancel is a no-op; conservation
    holds; the results are JAX's."""
    out = {}
    for name, (eng, Req) in _engines(models).items():
        rng = np.random.default_rng(4)
        rid0 = eng.submit(_mk(Req, rng, 6, max_new=16, seed=1))
        rid1 = eng.submit(_mk(Req, rng, 6, max_new=4, seed=2))
        rid2 = eng.submit(_mk(Req, rng, 6, max_new=4, seed=3))
        res2 = eng.cancel(rid2)
        assert res2.done_reason == "cancelled" and len(res2.tokens) == 0
        assert res2.energy_pj == 0.0 and res2.steps == 0
        results = [res2]
        while eng.scheduler.slot_of(rid0) is None or not any(
                s.generated for _, s in eng.scheduler.active_slots()
                if s.rid == rid0):
            results += eng.step()
        sid = eng.scheduler.slot_of(rid0)
        n_at_cancel = len(eng.scheduler.slots[sid].generated)
        res0 = eng.cancel(rid0)
        assert res0.done_reason == "cancelled"
        assert len(res0.tokens) == n_at_cancel > 0 and res0.energy_pj > 0
        assert eng.cancel(rid0) is None
        results += [res0] + eng.drain()
        assert {r.rid for r in results} == {rid0, rid1, rid2}
        eng.kv.check()
        assert eng.energy_conserved(results)
        out[name] = sorted(results, key=lambda r: r.rid)
    for a, b in zip(out["jax"], out["torch"]):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert (b.rid, b.done_reason, b.steps) == (a.rid, a.done_reason,
                                                   a.steps)
        np.testing.assert_allclose(b.energy_pj, a.energy_pj, rtol=1e-5)


# -- server level (threaded, the port) ----------------------------------------

def _jax_tokens(models, reqs):
    cfg_j, params_j = models[:2]
    eng = JEng(cfg_j, params_j, **PAGED)
    return [r.tokens for r in eng.serve(
        [JReq(prompt=r.prompt, max_new=r.max_new, seed=r.seed)
         for r in reqs])]


def test_server_streams_cotenants_and_conserves_energy(models):
    """Two co-tenants through StreamingServer: the second's first token
    arrives while the first is in flight, streams equal results and
    JAX's tokens, latencies are recorded, energy is conserved."""
    cfg_t, params_t = models[2:]
    eng = TEng(cfg_t, params_t, device="cpu", **PAGED)
    rng = np.random.default_rng(6)
    reqs = [_mk(TReq, rng, 8, max_new=12, seed=1),
            _mk(TReq, rng, 5, max_new=8, seed=2)]
    with StreamingServer(eng, max_pending=4) as srv:
        h0 = srv.submit(reqs[0])
        h1 = srv.submit(reqs[1])
        t1 = h1.next_token(timeout=120)
        assert t1 is not None
        assert not h0.done
        streamed1 = [t1] + list(h1.tokens(timeout=120))
        r0, r1 = h0.result(timeout=120), h1.result(timeout=120)
    assert r0.done_reason == "max_new" and r1.done_reason == "max_new"
    np.testing.assert_array_equal(np.asarray(streamed1, np.int32), r1.tokens)
    assert h0.ttft_s is not None and h0.ttft_s > 0
    assert len(h0.itl_s) == len(r0.tokens) - 1
    assert all(d >= 0 for d in h0.itl_s)
    assert srv.stats["completed"] == 2 and srv.stats["submitted"] == 2
    assert eng.energy_conserved([r0, r1])
    for got, want in zip((r0.tokens, r1.tokens), _jax_tokens(models, reqs)):
        np.testing.assert_array_equal(got, want)


def test_server_cancel_timeout_and_backpressure(models):
    """Cancel mid-stream (partial result, energy billed), a deadline that
    expires mid-flight ("timeout"), and a burst into a 1-deep admission
    queue that is partly rejected; the pool is consistent afterwards."""
    cfg_t, params_t = models[2:]
    eng = TEng(cfg_t, params_t, device="cpu", **PAGED)
    rng = np.random.default_rng(7)
    with StreamingServer(eng, max_pending=1) as srv:
        hc = srv.submit(_mk(TReq, rng, 6, max_new=24, seed=1))
        got = []
        for tok in hc.tokens(timeout=120):
            got.append(tok)
            if len(got) == 2:
                hc.cancel()
        rc = hc.result(timeout=120)
        assert rc.done_reason == "cancelled"
        assert len(rc.tokens) >= 2 and rc.energy_pj > 0
        np.testing.assert_array_equal(rc.tokens[:2], np.asarray(got[:2]))
        ht = srv.submit(_mk(TReq, rng, 6, max_new=24, seed=2),
                        deadline_s=0.05)
        rt = ht.result(timeout=120)
        assert rt.done_reason == "timeout" and len(rt.tokens) < 24
        accepted, rejected = [], 0
        for i in range(8):
            try:
                accepted.append(srv.submit(_mk(TReq, rng, 6, max_new=16,
                                               seed=10 + i)))
            except RejectedError:
                rejected += 1
        assert rejected > 0 and accepted
        for h in accepted:
            h.result(timeout=120)
    assert srv.stats["cancelled"] == 1 and srv.stats["timeout"] == 1
    assert srv.stats["rejected"] == rejected
    eng.kv.check()
    assert not eng.scheduler.busy


# -- the energy control plane ---------------------------------------------------

def test_validate_rejects_nonpositive_budget(pcm):
    sides, _ = pcm
    for name, (eng, Req, Ctl) in sides.items():
        for bad in (0.0, -1.0):
            with pytest.raises(ValueError, match="energy_budget_uj"):
                eng.validate(_req(Req, energy_budget_uj=bad))
        with pytest.raises(ValueError, match="step_budget_uj"):
            Ctl(step_budget_uj=0.0)


def test_budget_shed_partial_tokens_and_conservation(pcm):
    """A request past half its unconstrained cost is shed with its
    partial tokens ("energy_budget"), overrunning by less than a step;
    conservation holds; JAX's shed, tokens and energy."""
    sides, free = pcm
    out = {}
    for name, (eng, Req, Ctl) in sides.items():
        eng.controller = ctl = Ctl()
        try:
            snap = (eng.total_energy_pj, eng.idle_energy_pj)
            budget_uj = free[name].energy_pj * 1e-6 * 0.5
            res = eng.serve([_req(Req, energy_budget_uj=budget_uj)])[0]
            assert res.done_reason == "energy_budget"
            assert 0 < len(res.tokens) < free[name].tokens.size
            assert ctl.shed == 1
            assert res.energy_pj * 1e-6 >= budget_uj
            assert res.energy_pj < free[name].energy_pj
            d_total = eng.total_energy_pj - snap[0]
            d_idle = eng.idle_energy_pj - snap[1]
            assert np.isclose(res.energy_pj + d_idle, d_total, rtol=1e-6)
            out[name] = res
        finally:
            eng.controller = None
    np.testing.assert_array_equal(out["torch"].tokens, out["jax"].tokens)
    np.testing.assert_allclose(out["torch"].energy_pj, out["jax"].energy_pj,
                               rtol=1e-5)


def test_generous_budget_never_sheds(pcm):
    sides, free = pcm
    for name, (eng, Req, Ctl) in sides.items():
        eng.controller = ctl = Ctl()
        try:
            res = eng.serve([_req(Req, energy_budget_uj=free[name].energy_pj
                                  * 1e-5)])[0]
            assert res.done_reason == "max_new"
            np.testing.assert_array_equal(res.tokens, free[name].tokens)
            assert ctl.shed == 0
        finally:
            eng.controller = None


def test_bucket_defers_admission_until_drain(pcm):
    """A bucket refilling at 5% of a step's cost head-blocks the second
    request until the first drains (never two slots at once); the
    deferrals and results are JAX's."""
    sides, free = pcm
    out = {}
    for name, (eng, Req, Ctl) in sides.items():
        step_uj = free[name].energy_pj * 1e-6 / max(free[name].steps, 1)
        eng.controller = ctl = Ctl(step_budget_uj=0.05 * step_uj)
        try:
            eng.submit(_req(Req, seed=1))
            results = []
            for _ in range(3):
                results += eng.step()
            eng.submit(_req(Req, seed=2))
            max_active = 0
            for _ in range(64):
                results += eng.step()
                max_active = max(max_active, eng.scheduler.num_active)
                if not eng.scheduler.busy:
                    break
            assert not eng.scheduler.busy and max_active == 1
            assert ctl.deferred_steps > 0
            assert sorted(r.done_reason for r in results) == ["max_new"] * 2
            out[name] = (ctl.deferred_steps,
                         [r.tokens.tolist() for r in results])
        finally:
            eng.controller = None
    assert out["torch"] == out["jax"]


def test_streaming_server_sheds_on_budget(pcm):
    """The server surfaces a shed like a cancellation, under its own
    done_reason and stats key; the co-tenant completes; the ledger
    conserves with the shed partial."""
    sides, free = pcm
    eng, Req, Ctl = sides["torch"]
    eng.controller = ctl = Ctl()
    try:
        snap = (eng.total_energy_pj, eng.idle_energy_pj)
        budget_uj = free["torch"].energy_pj * 1e-6 * 0.4
        with StreamingServer(eng, max_pending=4) as srv:
            h_shed = srv.submit(_req(Req, seed=0, energy_budget_uj=budget_uj))
            h_ok = srv.submit(_req(Req, seed=6))
            shed, ok = h_shed.result(timeout=120), h_ok.result(timeout=120)
    finally:
        eng.controller = None
    assert shed.done_reason == "energy_budget"
    assert 0 < len(shed.tokens) < free["torch"].tokens.size
    np.testing.assert_array_equal(shed.tokens,
                                  free["torch"].tokens[:len(shed.tokens)])
    assert ok.done_reason == "max_new"
    assert srv.stats["energy_budget"] == 1 and srv.stats["completed"] == 1
    assert ctl.shed == 1
    d_total = eng.total_energy_pj - snap[0]
    d_idle = eng.idle_energy_pj - snap[1]
    assert np.isclose(shed.energy_pj + ok.energy_pj + d_idle, d_total,
                      rtol=1e-6)
