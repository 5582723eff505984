"""Port parity of the refcounted prefix cache (``repro_torch.serve.kv_pool``
and the engine's ``prefix_cache=True``), held JAX-vs-torch on the cases of
``tests/test_prefix_cache.py``.

Shrunk gemma3-1b (2 layers, all-global; analog with the per-row DAC
scale, or ideal), weights from JAX's init through the numpy bridge.  Each
engine scenario runs three times: on JAX's engine op by op with its DAC
levels recorded, on the port free-running, and on the port replaying
JAX's levels.  Tokens are held on the free-running port (identical),
ledgers within rtol 1e-5 on the replay (a float32 order difference can
flip a DAC level at a rounding tie, ROADMAP Queue 3), and the cache's
counters (cached prefix tokens, hits, evictions, prompt tokens computed)
must equal JAX's on both.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.core import emt_linear as jel
from repro.models import lm as jlm
from repro.nn.param import init_params
from repro.serve.engine import GenRequest as JReq
from repro.serve.engine import ServingEngine as JEng
from repro.serve.kv_pool import BlockPool as JPool
from repro.serve.kv_pool import prefix_keys as j_prefix_keys
from repro.serve.spec import ServeSpec as JSpec
from repro_torch.core import emt_linear as tel
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import GenRequest as TReq
from repro_torch.serve.engine import ServingEngine as TEng
from repro_torch.serve.kv_pool import BlockPool as TPool
from repro_torch.serve.kv_pool import prefix_key, prefix_keys
from repro_torch.serve.spec import ServeSpec as TSpec

BLOCK = 4
ENGINE = dict(batch_size=2, max_len=32, seed=7, fresh_noise=False,
              paged=True, block_size=BLOCK, prefill_chunk=8)

_MODELS = {}


def _models(emt):
    """(JAX cfg, JAX params, port cfg, port params) on the same weights."""
    if emt not in _MODELS:
        kw = dict(arch="gemma3-1b", mode=emt, smoke=True, all_global=True,
                  a_per_row=emt == "analog",
                  model_overrides={"num_layers": 2})
        cfg_j = JSpec(**kw).build_config()
        params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
        cfg_t = TSpec(**kw).build_config()
        params_t = tlm.load_jax_arrays(_tree_to_arrays(params_j), cfg_t,
                                       device="cpu")
        _MODELS[emt] = (cfg_j, params_j, cfg_t, params_t)
    return _MODELS[emt]


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


class _Side:
    """One side of a scenario: its engine and request classes and the
    model on that side."""

    def __init__(self, name, Eng, Req, cfg, params, kw):
        self.name, self.Req, self.cfg = name, Req, cfg
        self._Eng, self._params, self._kw = Eng, params, kw

    def engine(self, prefix_cache, **kw):
        args = dict(ENGINE, num_blocks=24, **self._kw)
        args.update(kw)
        return self._Eng(self.cfg, self._params, prefix_cache=prefix_cache,
                         **args)

    def req(self, prompt, **kw):
        return self.Req(prompt=np.asarray(prompt, np.int32), **kw)


def _held(emt, scenario):
    """Run `scenario(side) -> {"tokens": [...], "ledgers": {...},
    "counts": {...}}` on JAX op by op (DAC levels recorded), on the port
    free-running and on the port replaying JAX's levels, and hold the
    port to JAX.  Returns the free-running port's observations."""
    cfg_j, params_j, cfg_t, params_t = _models(emt)
    levels = []
    with jax.disable_jit(), _levels(jel, levels):
        want = scenario(_Side("jax", JEng, JReq, cfg_j, params_j, {}))
    port = _Side("torch", TEng, TReq, cfg_t, params_t, {"device": "cpu"})
    got = scenario(port)
    assert bool(levels) == (emt == "analog")
    runs = [("free-running", got)]
    if levels:
        replay = list(levels)
        with _levels(tel, [], replay):
            runs.append(("replay", scenario(port)))
        assert not replay, f"{len(replay)} recorded DAC calls not replayed"
    for what, obs in runs:
        assert len(obs["tokens"]) == len(want["tokens"])
        for i, (a, b) in enumerate(zip(want["tokens"], obs["tokens"])):
            np.testing.assert_array_equal(
                np.asarray(b), np.asarray(a),
                err_msg=f"{what}: tokens of request {i}")
        assert obs["counts"] == want["counts"], what
    if len(runs) > 1:
        rep = runs[1][1]["ledgers"]
        for k, v in want["ledgers"].items():
            np.testing.assert_allclose(rep[k], v, rtol=1e-5, err_msg=k)
    return got


def _ledgers(eng, results=()):
    m = eng.metrics()
    out = {k: m[k] for k in ("total_energy_pj", "idle_energy_pj",
                             "kv_reads_total")}
    for i, r in enumerate(results):
        out[f"energy_pj[{i}]"] = r.energy_pj
        out[f"prefill_energy_pj[{i}]"] = r.prefill_energy_pj
    return out


def _counts(eng):
    m = eng.metrics()
    out = {k: m[k] for k in ("steps", "prefill_tokens_total",
                             "cached_prefix_tokens")}
    if eng.kv is not None:
        out.update(hits=eng.kv.prefix_hits,
                   evictions=eng.kv.prefix_evictions,
                   cached_blocks=eng.kv.pool_g.num_cached)
    return out


@pytest.mark.parametrize("emt", ["ideal", "analog"])
def test_token_identity_caching_on_vs_off(emt):
    """Shared-prefix requests (a 10-token header, staggered 3 steps) give
    the same tokens with the cache on and off, as on JAX, with JAX's
    cached-token counts."""
    cfg = _models(emt)[2]
    rng = np.random.default_rng(3)
    head = rng.integers(0, cfg.vocab_size, 10)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab_size, 6)])
               for _ in range(4)]

    def scenario(side):
        obs = {"tokens": [], "ledgers": {}, "counts": {}}
        for pc in (False, True):
            eng = side.engine(pc)
            res = eng.serve([side.req(p, max_new=4, seed=i)
                             for i, p in enumerate(prompts)], stagger=3)
            obs["tokens"] += [r.tokens for r in res]
            obs["ledgers"].update({f"{pc}/{k}": v for k, v in
                                   _ledgers(eng, res).items()})
            obs["counts"].update({f"{pc}/{k}": v for k, v in
                                  _counts(eng).items()})
            assert eng.energy_conserved(res)
            if pc:
                eng.kv.check()
        return obs

    got = _held(emt, scenario)
    off, on = got["tokens"][:4], got["tokens"][4:]
    for rid, (a, b) in enumerate(zip(off, on)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {rid}")
    c = got["counts"]
    assert c["True/cached_prefix_tokens"] >= 2 * BLOCK
    assert c["True/prefill_tokens_total"] == \
        c["False/prefill_tokens_total"] - c["True/cached_prefix_tokens"]


def test_identical_prompt_and_partial_tail_cow():
    """An identical repeat prompt reuses every full block; a prompt that
    diverges inside a registered block reuses its head copy-on-write; the
    forked stream equals a cache-off engine's."""
    cfg = _models("ideal")[2]
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab_size, 9)
    fork = base.copy()
    fork[6:] = (fork[6:] + 1) % cfg.vocab_size

    def scenario(side):
        eng = side.engine(True)
        cached = []
        for p, seed in ((base, 0), (base, 0), (fork, 1)):
            eng.serve([side.req(p, max_new=3, seed=seed)])
            cached.append(eng.cached_prefix_tokens)
        eng.kv.check()
        ref = side.engine(False)
        want = ref.serve([side.req(fork, max_new=3, seed=1)])[0].tokens
        got = eng.serve([side.req(fork, max_new=3, seed=1)])[0].tokens
        return {"tokens": [want, got], "ledgers": {},
                "counts": dict(_counts(eng), cached=cached)}

    got = _held("ideal", scenario)
    assert got["counts"]["cached"] == [0, 2 * BLOCK, 3 * BLOCK + 2]
    np.testing.assert_array_equal(got["tokens"][1], got["tokens"][0])


def test_cache_hit_prefix_bills_zero_incremental_cost():
    """A resident prompt admitted again computes only its last token: less
    energy and fewer K/V reads than the cold admission, JAX's ledgers on
    JAX's levels."""
    cfg = _models("analog")[2]
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 12)

    def scenario(side):
        eng = side.engine(True)
        cold = eng.serve([side.req(prompt, max_new=2, seed=0)])
        snap = _ledgers(eng)
        cold_tokens = eng.prefill_tokens_total
        warm = eng.serve([side.req(prompt, max_new=2, seed=0)])
        led = {f"cold/{k}": v for k, v in snap.items()}
        led.update({f"all/{k}": v for k, v in _ledgers(eng).items()})
        led["warm prefill_energy_pj"] = warm[0].prefill_energy_pj
        return {"tokens": [cold[0].tokens, warm[0].tokens], "ledgers": led,
                "counts": dict(_counts(eng), cold_tokens=cold_tokens)}

    got = _held("analog", scenario)
    c, led = got["counts"], got["ledgers"]
    assert c["cold_tokens"] == len(prompt)
    assert c["cached_prefix_tokens"] == len(prompt) - 1
    assert c["prefill_tokens_total"] - c["cold_tokens"] == 1
    for k in ("total_energy_pj", "kv_reads_total"):
        warm = led[f"all/{k}"] - led[f"cold/{k}"]
        assert 0 < warm < led[f"cold/{k}"], k
    assert led["warm prefill_energy_pj"] > 0


def test_decode_written_blocks_register_and_serve_continuation():
    """Blocks that decode fills register under the written stream's hashes:
    the conversation replayed as a prompt hits all three full blocks (two
    of them decode-written), computes one token, and gives a cache-off
    engine's tokens; a repeat is free again."""
    cfg = _models("analog")[2]
    prompt = np.random.default_rng(13).integers(0, cfg.vocab_size, 6)

    def scenario(side):
        eng = side.engine(True)
        first = eng.serve([side.req(prompt, max_new=7, seed=0)])[0]
        base = _counts(eng)
        base_uj = eng.total_energy_pj
        cont = np.concatenate([prompt, np.asarray(first.tokens, np.int32)])
        second = eng.serve([side.req(cont, max_new=3, seed=1)])[0]
        mid = _counts(eng)
        warm_uj = eng.total_energy_pj - base_uj
        eng.kv.check()
        want = side.engine(False).serve(
            [side.req(cont, max_new=3, seed=1)])[0]
        eng.serve([side.req(cont, max_new=3, seed=1)])
        return {"tokens": [first.tokens, second.tokens, want.tokens],
                "ledgers": {"base_uj": base_uj, "warm_uj": warm_uj},
                "counts": {"base": base, "mid": mid, "end": _counts(eng),
                           "cont": len(cont)}}

    got = _held("analog", scenario)
    c, led = got["counts"], got["ledgers"]
    assert c["cont"] == 13 and c["base"]["cached_prefix_tokens"] == 0
    assert c["mid"]["cached_prefix_tokens"] == 3 * BLOCK
    assert c["mid"]["prefill_tokens_total"] - \
        c["base"]["prefill_tokens_total"] == 1
    assert c["end"]["prefill_tokens_total"] - \
        c["mid"]["prefill_tokens_total"] == 1
    assert 0 < led["warm_uj"] < led["base_uj"]
    np.testing.assert_array_equal(got["tokens"][1], got["tokens"][2])


def test_refcount_conservation_under_churn():
    """Randomized serve churn over a tight pool (12 blocks): conservation
    after every drain, nothing held after it, hits and evictions as many
    as JAX's."""
    cfg = _models("ideal")[2]
    rng = np.random.default_rng(11)
    head = rng.integers(0, cfg.vocab_size, 8)
    rounds = []
    for _ in range(6):
        n = int(rng.integers(1, 4))
        reqs = [(np.concatenate([head, rng.integers(
                    0, cfg.vocab_size, int(rng.integers(1, 7)))]),
                 int(rng.integers(1, 4)), i) for i in range(n)]
        rounds.append((reqs, int(rng.integers(0, 3))))

    def scenario(side):
        eng = side.engine(True, num_blocks=12)
        tokens, counts = [], []
        for reqs, stagger in rounds:
            res = eng.serve([side.req(p, max_new=m, seed=s)
                             for p, m, s in reqs], stagger=stagger)
            tokens += [r.tokens for r in res]
            eng.kv.check()
            pool = eng.kv.pool_g
            assert pool.num_owned == 0
            assert pool.num_free == pool.num_blocks
            counts.append(_counts(eng))
        return {"tokens": tokens, "ledgers": {}, "counts": {"c": counts}}

    got = _held("ideal", scenario)
    assert got["counts"]["c"][-1]["hits"] > 0


def test_blockpool_refcounts_and_eviction_unit():
    """The host allocator, step by step against JAX's: sharing, parking,
    eviction reported for zeroing, conservation; prefix keys byte-equal
    to JAX's."""
    toks = np.arange(BLOCK, dtype=np.int32)
    assert prefix_keys(toks, BLOCK) == j_prefix_keys(toks, BLOCK)
    long = np.random.default_rng(0).integers(0, 1 << 20, 37)
    assert prefix_keys(long, BLOCK) == j_prefix_keys(long, BLOCK)
    (key,) = prefix_keys(toks, BLOCK)
    assert prefix_key(None, toks) == key

    pools = {"jax": JPool(4, BLOCK), "torch": TPool(4, BLOCK)}
    seen = {}
    for name, pool in pools.items():
        out = []
        ids = pool.alloc(0, 2)
        out.append((list(ids), pool.refcount(ids[0])))
        pool.register(ids[0], key, None, toks)
        pool.acquire(1, ids[0])
        out.append(pool.refcount(ids[0]))
        pool.check()
        out.append(pool.free(0))                 # the private block blanks
        out.append(pool.refcount(ids[0]))
        out.append(pool.free(1))                 # the registered one parks
        out.append((pool.num_cached, pool.lookup(key)))
        pool.check()
        out.append(pool.alloc(7, 4))             # evicts the parked block
        out.append((pool.lookup(key), pool.pop_evicted(), pool.evictions))
        pool.check()
        pool.free(7)
        out.append((pool.num_free, pool.hits))
        seen[name] = out
    assert seen["torch"] == seen["jax"]
    t = seen["torch"]
    assert t[2] == [t[0][0][1]] and t[3] == 1 and t[4] == []
    assert t[5] == (1, t[0][0][0]) and t[7][:2] == (None, [t[0][0][0]])


def test_blockpool_eviction_order_matches_jax():
    """A random sequence of allocations, shares, registrations and frees
    over a small pool: every return value, the coldest-first eviction
    order with decay, and the reuse weights equal JAX's."""
    rng = np.random.default_rng(1)
    ops = []
    for _ in range(300):
        ops.append((int(rng.integers(0, 5)), int(rng.integers(0, 6)),
                    int(rng.integers(0, 3)), int(rng.integers(0, 1 << 30))))
    logs = {}
    for name, Pool in (("jax", JPool), ("torch", TPool)):
        pool, log, owners, keys = Pool(10, BLOCK), [], set(), []
        for op, owner, n, salt in ops:
            if op == 0 and owner not in owners:
                ids = pool.alloc(owner, n + 1, reserve=n % 2)
                if ids is not None:
                    owners.add(owner)
                log.append(("alloc", ids))
            elif op == 1 and owner in owners:
                log.append(("free", pool.free(owner)))
                owners.discard(owner)
            elif op == 2 and owner in owners:
                bid = pool.owned(owner)[-1]
                k = prefix_key(None, np.full(BLOCK, salt, np.int32))
                log.append(("register", pool.register(bid, k, None,
                                                      np.full(BLOCK, salt))))
                keys.append(k)
            elif op == 3 and keys and owner not in owners:
                bid = pool.lookup(keys[salt % len(keys)])
                if bid is not None:
                    pool.acquire(owner, bid)
                    owners.add(owner)
                log.append(("acquire", bid))
            elif op == 4:
                log.append(("evicted", pool.pop_evicted()))
            pool.check()
            log.append((pool.num_free, pool.num_cached, pool.num_owned,
                        sorted(round(pool.reuse_weight(b), 12)
                               for b in range(10))))
        logs[name] = (log, pool.hits, pool.evictions)
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][2] > 0


def test_prefix_cache_requires_supported_stack():
    """A ring stack or a contiguous cache is refused with JAX's
    ValueError and message."""
    cfg_j, params_j, cfg_t, params_t = _models("ideal")
    ring_j = cfg_j.replace(layer_pattern=("local", "global"),
                           sliding_window=4)
    ring_t = cfg_t.replace(layer_pattern=("local", "global"),
                           sliding_window=4)
    for kw, match in ((dict(paged=True, block_size=4), "all-global"),
                      (dict(), "paged")):
        with pytest.raises(ValueError, match=match) as jerr:
            JEng(ring_j, params_j, batch_size=2, max_len=16,
                 prefix_cache=True, **kw)
        with pytest.raises(ValueError, match=match) as terr:
            TEng(ring_t, params_t, batch_size=2, max_len=16,
                 prefix_cache=True, device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)


def test_cow_donor_block_is_unchanged():
    """After a copy-on-write admission, the donor block's rows stay as
    they were across the new slot's whole run: the slot's writes (its
    prefill chunks and the in-place decode writes) land only in its
    private copy."""
    cfg, params = _models("analog")[2:]
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    fork = base.copy()
    fork[6:] = (fork[6:] + 1) % cfg.vocab_size
    eng = TEng(cfg, params, prefix_cache=True, num_blocks=24, device="cpu",
               **ENGINE)
    eng.serve([TReq(prompt=base, max_new=3, seed=0)])
    keys = prefix_keys(base, BLOCK)
    donor = eng.kv.pool_g.lookup(keys[1])
    assert donor is not None and eng.kv.pool_g.refcount(donor) == 0
    before = {(n, k): p[donor].clone() for n, blk in eng.cache.items()
              for k, p in blk.items()}
    copies = []
    admit = eng.kv.admit_prefix

    def traced(slot, prompt, max_new):
        res = admit(slot, prompt, max_new)
        copies.append(res["cow"])
        return res

    eng.kv.admit_prefix = traced
    rid = eng.submit(TReq(prompt=fork, max_new=6, seed=1))
    while eng.scheduler.busy:
        eng.step()
        for (n, k), want in before.items():
            assert torch.equal(eng.cache[n][k][donor], want), (n, k)
    assert copies == [(donor, copies[0][1])] and copies[0][1] != donor
    assert eng.cached_prefix_tokens == BLOCK + 2 and rid == 1
    eng.kv.check()


def test_evicted_block_is_zeroed_before_its_new_owner_steps():
    """A registered block evicted for a new admission holds its previous
    owner's K/V; the engine zeroes it before the new owner's first step,
    as it zeroes a retired slot's blank blocks (the decode kernels assume
    masked pool entries are finite, and a blank block reads as zeros)."""
    cfg, params = _models("ideal")[2:]
    eng = TEng(cfg, params, prefix_cache=True, device="cpu",
               **dict(ENGINE, batch_size=1, num_blocks=6))
    rng = np.random.default_rng(2)
    a, b = (rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in (12, 16))
    eng.serve([TReq(prompt=a, max_new=2)])
    pool = eng.kv.pool_g
    assert pool.num_cached == 3 and pool.evictions == 0
    cached = {bid: eng.cache["layer_000"]["k"][bid].clone()
              for bid in pool._cached}
    assert all(float(v.abs().max()) > 0 for v in cached.values())
    eng.submit(TReq(prompt=b, max_new=2))
    eng.step()                      # admits b (one eviction), first chunk
    assert pool.evictions == 1
    (victim,) = [bid for bid in cached if pool.key_of(bid) is None]
    j = int(np.flatnonzero(eng.kv.table_g[0] == victim)[0])
    assert j * BLOCK >= ENGINE["prefill_chunk"]   # not written yet
    for blk in eng.cache.values():
        for t in blk.values():
            assert float(t[victim].abs().max()) == 0.0
    eng.drain()
    eng.kv.check()
