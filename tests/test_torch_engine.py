"""Port parity: the paged, chunked-prefill ServingEngine of repro_torch
against the JAX engine on identical weights and schedules.

Both engines serve the same staggered requests (shrunk gemma3-1b, 2
layers, analog, all-global, paged block 8, chunk 8); token streams must be
identical (greedy and temperature 0.8 / top-k 40), per-request energy and
idle energy within rtol 1e-5 (float32 sums of weight-sized reductions in a
different order), and energy conserved.  The JAX engines run once per
module (their compiles dominate).
"""
import jax
import numpy as np
import pytest

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.models import lm as jlm
from repro.nn.param import init_params
from repro.serve.engine import GenRequest as JReq
from repro.serve.engine import ServingEngine as JEng
from repro.serve.engine import view_bucket as j_view_bucket
from repro.serve.spec import ServeSpec
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import GenRequest as TReq
from repro_torch.serve.engine import ServingEngine as TEng
from repro_torch.serve.engine import view_bucket as t_view_bucket
from repro_torch.serve.scheduler import RejectedError
from repro_torch.serve.spec import build_config

ENGINE = dict(batch_size=3, max_len=48, seed=7, paged=True, block_size=8,
              prefill_chunk=8)


def _models(a_per_row):
    cfg_j = ServeSpec(arch="gemma3-1b", mode="analog", smoke=True,
                      all_global=True, a_per_row=a_per_row).build_config() \
        .replace(num_layers=2)
    params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
    cfg_t = build_config(smoke=True, all_global=True, a_per_row=a_per_row,
                         model_overrides={"num_layers": 2})
    params_t = tlm.load_jax_arrays(_tree_to_arrays(params_j), cfg_t,
                                   device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _request_specs():
    rng = np.random.default_rng(3)
    out = []
    for i, plen in enumerate([11, 3, 20, 7, 14]):
        kw = dict(prompt=rng.integers(0, 512, plen).astype(np.int32),
                  max_new=6 + i, seed=100 + i)
        if i in (1, 3):
            kw.update(temperature=0.8, top_k=40)
        out.append(kw)
    return out


@pytest.fixture(scope="module")
def staggered():
    cfg_j, params_j, cfg_t, params_t = _models(a_per_row=True)
    runs = {}
    for tag, Eng, Req, cfg, params, kw in (
            ("jax", JEng, JReq, cfg_j, params_j, {}),
            ("torch", TEng, TReq, cfg_t, params_t, {"device": "cpu"})):
        eng = Eng(cfg, params, fresh_noise=False, **ENGINE, **kw)
        res = eng.serve([Req(**s) for s in _request_specs()], stagger=2)
        runs[tag] = (eng, res)
    return runs


def test_token_streams_identical(staggered):
    (ej, rj), (et, rt) = staggered["jax"], staggered["torch"]
    assert et.view_len == ej.view_len > 0          # same clamped view bucket
    assert [r.rid for r in rt] == [r.rid for r in rj] == list(range(5))
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.tokens, a.tokens,
                                      err_msg=f"rid {a.rid}")
        assert b.done_reason == a.done_reason
        assert b.steps == a.steps


def test_energy_ledgers_match_and_conserve(staggered):
    (ej, rj), (et, rt) = staggered["jax"], staggered["torch"]
    for a, b in zip(rj, rt):
        np.testing.assert_allclose(b.energy_pj, a.energy_pj, rtol=1e-5)
        np.testing.assert_allclose(b.prefill_energy_pj, a.prefill_energy_pj,
                                   rtol=1e-5)
    np.testing.assert_allclose(et.idle_energy_pj, ej.idle_energy_pj,
                               rtol=1e-5)
    np.testing.assert_allclose(et.total_energy_pj, ej.total_energy_pj,
                               rtol=1e-5)
    assert et.energy_conserved(rt) and ej.energy_conserved(rj)
    mj, mt = ej.metrics(), et.metrics()
    for k in ("steps", "peak_concurrent", "prefill_tokens_total"):
        assert mt[k] == mj[k], k
    np.testing.assert_allclose(mt["kv_reads_total"], mj["kv_reads_total"],
                               rtol=1e-6)
    assert set(mt["corner_energy_pj"]) == set(mj["corner_energy_pj"])


@pytest.fixture(scope="module")
def backcompat():
    """The schedule of tests/test_serve_continuous.py::
    test_generate_backcompat_and_eos (fresh noise, per-tensor DAC scale),
    on the port's paged chunked engine: the port is held to the JAX
    engine's actual streams, whatever they are."""
    cfg_j, params_j, cfg_t, params_t = _models(a_per_row=False)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, 4).astype(np.int32) for _ in range(2)]
    kw = dict(ENGINE, batch_size=2, max_len=16, seed=3)
    out = {}
    for tag, Eng, Req, cfg, params, dk in (
            ("jax", JEng, JReq, cfg_j, params_j, {}),
            ("torch", TEng, TReq, cfg_t, params_t, {"device": "cpu"})):
        eng = Eng(cfg, params, **kw, **dk)
        reqs = [Req(prompt=p, max_new=4) for p in prompts]
        outs1, e1 = eng.generate(reqs)
        outs2, e2 = eng.generate(reqs)
        eos = int(outs1[0][0])
        eng2 = Eng(cfg, params, **kw, **dk)
        eng2.submit(Req(prompt=prompts[0], max_new=4, eos_id=eos))
        (res,) = eng2.drain()
        out[tag] = (outs1, e1, outs2, e2, res)
    return out


def test_generate_backcompat_and_eos_streams_match_jax(backcompat):
    j, t = backcompat["jax"], backcompat["torch"]
    for a, b in zip(t[0], t[2]):                 # noise clock resets
        np.testing.assert_array_equal(a, b)
    assert t[1] > 0 and abs(t[1] - t[3]) / t[1] < 1e-6
    for a, b in zip(j[0], t[0]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5)
    np.testing.assert_array_equal(t[4].tokens, j[4].tokens)
    assert t[4].done_reason == j[4].done_reason


def test_view_bucket_matches_jax():
    for need in (1, 7, 8, 9, 16, 17, 40, 48, 100):
        for bs, max_len in ((8, 48), (16, 128), (4, 64)):
            assert t_view_bucket(need, bs, max_len) == \
                j_view_bucket(need, bs, max_len)


@pytest.fixture(scope="module")
def small_port():
    return _models(a_per_row=True)[2:]


def test_cancel_queued_and_active(small_port):
    cfg, params = small_port
    eng = TEng(cfg, params, fresh_noise=False, device="cpu", **ENGINE)
    rng = np.random.default_rng(0)
    reqs = [TReq(prompt=rng.integers(0, 512, 10).astype(np.int32), max_new=8)
            for _ in range(5)]
    rids = [eng.submit(r) for r in reqs]
    eng.step()
    eng.step()
    queued = eng.cancel(rids[4])
    assert queued.done_reason == "cancelled" and len(queued.tokens) == 0
    live = eng.cancel(rids[0], reason="timeout")
    assert live.done_reason == "timeout" and live.energy_pj > 0
    assert eng.cancel(rids[0]) is None
    rest = eng.drain()
    assert sorted(r.rid for r in rest) == rids[1:4]
    assert eng.energy_conserved(rest + [live, queued])
    eng.kv.check()
    assert eng.kv.pool_g.num_free == eng.kv.pool_g.num_blocks
    for blk in eng.cache.values():               # retired blocks zeroed
        assert float(blk["k"].abs().sum()) == 0.0


def test_validation_and_backpressure(small_port):
    cfg, params = small_port
    eng = TEng(cfg, params, device="cpu", max_pending=1, **ENGINE)
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(TReq(prompt=np.zeros(49, np.int32)))
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(TReq(prompt=np.zeros(3, np.int32), max_new=0))
    with pytest.raises(ValueError, match="temperature"):
        eng.submit(TReq(prompt=np.zeros(3, np.int32), temperature=-1.0))
    eng.submit(TReq(prompt=np.zeros(3, np.int32), max_new=2))
    with pytest.raises(RejectedError):
        eng.submit(TReq(prompt=np.zeros(3, np.int32), max_new=2))
    (res,) = eng.drain()
    assert res.done_reason == "max_new" and len(res.tokens) == 2
    eng.reset_metrics()
    assert eng.metrics()["total_energy_pj"] == 0.0


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(paged=False, prefix_cache=True),
                 "requires paged=True and chunked prefill",
                 id="kw0-prefix cache"),
    pytest.param(dict(chunked_prefill=True, arch="seamless-m4t-medium"),
                 "chunked_prefill", id="kw1-chunked_prefill"),
    pytest.param(dict(prefix_cache=True, arch="gemma3-1b"),
                 "requires an all-global attention stack",
                 id="kw2-prefix cache"),
    pytest.param(dict(n_shards=2), "sharded", id="kw3-sharded"),
])
def test_unported_engine_modes_raise(small_port, kw, match):
    """Sharded serving is not ported yet (NotImplementedError); JAX's
    ValueErrors refuse the prefix cache on a contiguous cache and on a
    ring stack (gemma3-1b smoke as published), and chunked prefill on an
    encoder-decoder stack."""
    kw = dict(kw)
    arch = kw.pop("arch", None)
    cfg, params = small_port
    exc = NotImplementedError
    if arch is not None or "prefix_cache" in kw:
        exc = ValueError
    if arch is not None:
        cfg = build_config(arch, smoke=True)
        params = tlm.init_model_params(cfg, 0, device="cpu")
    args = dict(ENGINE, **kw)
    with pytest.raises(exc, match=match):
        TEng(cfg, params, device="cpu", **args)


def test_sample_tokens_matches_jax():
    """Greedy, temperature, top-k and top-p rows draw the same tokens as
    the JAX sampler (Gumbel uniforms bit-exact; see test_torch_hashrng)."""
    import jax.numpy as jnp
    import torch

    from repro.serve.sampling import sample_tokens as j_sample
    from repro_torch.serve.sampling import sample_tokens as t_sample
    rng = np.random.default_rng(8)
    B, V = 6, 300
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    temps = np.asarray([0.0, 0.8, 1.5, 0.8, 1.0, 0.5], np.float32)
    topk = np.asarray([0, 40, 0, 5, 0, 1], np.int32)
    topp = np.asarray([1.0, 1.0, 0.9, 0.5, 0.3, 1.0], np.float32)
    seeds = np.arange(B, dtype=np.uint32) * 7919
    for step in range(8):
        pos = np.full(B, step, np.int32)
        want = np.asarray(j_sample(jnp.asarray(logits), jnp.asarray(temps),
                                   jnp.asarray(topk), jnp.asarray(topp),
                                   jnp.asarray(seeds), jnp.asarray(pos)))
        got = t_sample(torch.from_numpy(logits), temps, topk, topp, seeds,
                       pos).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
    greedy = t_sample(torch.from_numpy(logits), np.zeros(B, np.float32),
                      topk, topp, seeds, pos).numpy()
    np.testing.assert_array_equal(greedy, logits.argmax(-1))
