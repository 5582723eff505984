"""Port parity of the sliding-window ring layout: gemma3-1b smoke as
published, 6 layers (5 local of window 8 and 1 global; as
tests/test_kv_paged.py builds it), per-row DAC scale, on both KV layouts.

* Layouts: ``paged_lens``/``clamped_lens`` below, at and above the window.
* Attention, on identical post-RoPE q/k/v (the projections, RoPE and the
  output projection are replaced by the identity in both packages, so the
  K/V written are the same bits): ring prefill at S < win, S = win and
  S > win; the chunk step (ring and global, contiguous and paged at blocks
  of 4 and 16, chunk 16 over window 8, an inactive row); decode (ring and
  global, both layouts, an inactive row, rings that wrapped).  Outputs
  within 1e-5 absolute (float32, |y| < 4), caches bit-identical after the
  writes, kv_reads equal.
* PagedKV's global and ring accounting against JAX's on a random
  admit/ensure/release schedule.
* Engines: the JAX contiguous engine (run op by op so its DAC levels can
  be recorded) against the port's contiguous and paged engines on
  staggered requests that wrap every ring, chunked prefill: greedy and
  sampled tokens identical; ledgers within rtol 1e-5 on a run replaying
  JAX's DAC levels (free-running, a level at a float32 rounding tie can
  round the other way and move a ledger by ~1e-5, ROADMAP Queue 3).
* Cancel mid-decode, retired regions and ring blocks zeroed, admission on
  a small ring pool; K1 on a wrapped ring table on the card (``gpu``).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ja
import repro.models.common as jc
import repro_torch.models.attention as ta
import repro_torch.models.common as tc
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

WIN = 8
ENGINE = dict(batch_size=3, max_len=48, seed=7, block_size=16,
              prefill_chunk=16)


def _configs():
    cfg_j = ServeSpec(arch="gemma3-1b", mode="analog", smoke=True,
                      a_per_row=True).build_config()
    cfg_t = build_config(smoke=True, a_per_row=True)
    assert cfg_t.blocks() == cfg_j.blocks() == ("local",) * 5 + ("global",)
    assert cfg_t.sliding_window == cfg_j.sliding_window == WIN
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def models():
    cfg_j, cfg_t = _configs()
    params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
    params_t = tlm.load_jax_arrays(_tree_to_arrays(params_j), cfg_t,
                                   device="cpu")
    return cfg_j, params_j, cfg_t, params_t


# -- layouts -----------------------------------------------------------------
@pytest.mark.parametrize("max_len", [4, WIN, 48])
def test_paged_lens_and_clamped_lens_match_jax(max_len):
    cfg_j, cfg_t = _configs()
    lens_t, lens_j = tlm.paged_lens(cfg_t, max_len), \
        jlm.paged_lens(cfg_j, max_len)
    assert lens_t == lens_j
    assert lens_t["ring"] == (max_len > WIN)
    for view in (1, 4, WIN, 16, max_len):
        assert tlm.clamped_lens(lens_t, view) == \
            jlm.clamped_lens(lens_j, view)
    ring = tlm.ring_layers(cfg_t, lens_t)
    assert ring == ({f"layer_{i:03d}" for i in range(5)}
                    if lens_t["ring"] else set())
    # contiguous ring buffers and paged ring pools of the shapes JAX gives
    for t, j in ((tlm.init_cache(cfg_t, 2, max_len, device="cpu"),
                  jlm.init_cache(cfg_j, 2, max_len)),
                 (tlm.init_paged_cache(cfg_t, 2, max_len, 4, 6, 3,
                                       device="cpu"),
                  jlm.init_paged_cache(cfg_j, 2, max_len, 4, 6, 3))):
        assert {n: {k: tuple(v.shape) for k, v in b.items()}
                for n, b in t.items()} == \
            {n: {k: tuple(v.shape) for k, v in b.items()}
             for n, b in j.items()}


# -- attention on identical q, k, v -----------------------------------------
@pytest.fixture
def attend(monkeypatch):
    """Both packages' self_attention on given post-RoPE q (B, S, H, hd) and
    k/v (B, S, KV, hd): the QKV projection returns them, RoPE and the
    output projection are the identity.  Returns run(cfg_j, cfg_t, q, k, v,
    jax_kw, torch_kw) -> ((y, kv_reads, cache) JAX, (...) port) as numpy."""
    box = {}
    monkeypatch.setattr(ja, "_project_qkv", lambda p, xq, xkv, cfg, ctx, tag:
                        (*box["j"], jel.new_aux()))
    monkeypatch.setattr(ta, "_project_qkv", lambda p, x, cfg, ctx, tag:
                        (*box["t"], tel.new_aux()))
    monkeypatch.setattr(jc, "apply_rope", lambda x, pos, theta=0.0: x)
    monkeypatch.setattr(tc, "apply_rope", lambda x, pos, theta=0.0: x)
    monkeypatch.setattr(ja, "emt_dense", lambda p, y, emt, **kw:
                        (y, jel.new_aux()))
    monkeypatch.setattr(ta, "emt_dense", lambda p, y, emt, **kw:
                        (y, tel.new_aux()))

    def run(cfg_j, cfg_t, q, k, v, jkw, tkw):
        box["j"] = tuple(jnp.asarray(a) for a in (q, k, v))
        box["t"] = tuple(torch.from_numpy(a) for a in (q, k, v))
        B, S = q.shape[:2]
        yj, aj, cj = ja.self_attention(
            {"wo": None}, jnp.zeros((B, S, cfg_j.d_model)), cfg_j,
            ctx=JCtx(), tag="t", **jkw)
        yt, at, ct = ta.self_attention(
            {"wo": None}, torch.zeros((B, S, cfg_t.d_model)), cfg_t,
            ctx=TCtx(), tag="t", **tkw)
        return ((np.asarray(yj), float(aj["kv_reads"]),
                 {n: np.asarray(a) for n, a in cj.items()}),
                (yt.numpy(), float(at["kv_reads"]),
                 {n: a.numpy() for n, a in ct.items()}))

    return run


def _same(out, atol=1e-5):
    (yj, rj, cj), (yt, rt, ct) = out
    np.testing.assert_allclose(yt, yj, rtol=0, atol=atol)
    assert rt == rj
    assert set(ct) == set(cj)
    for n in cj:
        np.testing.assert_array_equal(ct[n], cj[n], err_msg=n)


def _qkv(rng, B, S, cfg):
    G = cfg.num_heads // cfg.num_kv_heads
    hd = cfg.head_dim
    q = rng.normal(size=(B, S, cfg.num_kv_heads * G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, cfg.num_kv_heads, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, cfg.num_kv_heads, hd)).astype(np.float32)
    return q, k, v


def _both(d):
    """{name: numpy} -> (JAX dict, port dict)."""
    return ({n: jnp.asarray(a) for n, a in d.items()},
            {n: torch.from_numpy(a.copy()) for n, a in d.items()})


def _kwargs(**kw):
    """numpy keyword arguments -> (JAX kwargs, port kwargs)."""
    jkw, tkw = {}, {}
    for n, a in kw.items():
        if isinstance(a, np.ndarray):
            jkw[n] = jnp.asarray(a)
            tkw[n] = torch.from_numpy(a.copy())
            if a.dtype.kind == "i" and n not in ("page_table",):
                tkw[n] = tkw[n].long()
        else:
            jkw[n] = tkw[n] = a
    return jkw, tkw


def _local(cfg_j, cfg_t, window):
    return cfg_j.replace(sliding_window=window), \
        cfg_t.replace(sliding_window=window)


def _mask(qpos, L, window):
    k_pos = np.broadcast_to(np.arange(L), (qpos.shape[0], L))
    return np.asarray(jc.causal_mask(jnp.asarray(qpos), jnp.asarray(k_pos),
                                     window))


@pytest.mark.parametrize("S", [5, WIN, 13])
def test_ring_prefill_keeps_the_last_window(attend, S):
    """Contiguous ring prefill: S < win fills slots [0, S); S >= win keeps
    the last win positions at slots p mod win (rolled by (S - win) mod
    win)."""
    cfg_j, cfg_t = _local(*_configs(), WIN)
    rng = np.random.default_rng(S)
    B = 2
    q, k, v = _qkv(rng, B, S, cfg_t)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    cache = np.zeros((B, WIN, 1, cfg_t.head_dim), np.float32)
    cj, ct = _both({"k": cache, "v": cache})
    jkw, tkw = _kwargs(positions=pos, mask=_mask(pos, S, WIN))
    out = attend(cfg_j, cfg_t, q, k, v, dict(jkw, cache=cj),
                 dict(tkw, cache=ct))
    _same(out)
    kept = out[1][2]["k"]
    for p in range(max(0, S - WIN), S):
        np.testing.assert_array_equal(kept[:, p % WIN], k[:, p])


def _pools(rng, rows, bs, hd):
    pool = rng.normal(size=(rows + 1, bs, 1, hd)).astype(np.float32)
    pool[rows] = 0.0
    return pool


def _tables(rng, B, width, rows):
    """(B, width) distinct block ids of a pool of `rows` blocks."""
    return rng.permutation(rows)[:B * width].reshape(B, width) \
        .astype(np.int32)


@pytest.mark.parametrize("layout", ["contiguous", "paged-bs4", "paged-bs16"])
@pytest.mark.parametrize("kind", ["ring", "global"])
def test_chunk_attend_matches_jax(attend, layout, kind):
    """The chunk step's attention (chunk 16 over window 8): rows starting
    at 0, mid-window, after the ring wrapped and on a single decode lane;
    the last row inactive.  A ring row attends [pre-write ring view |
    fresh chunk]; of the lanes that wrap to one slot only the last
    writes."""
    cfg_j, cfg_t = _local(*_configs(), WIN if kind == "ring" else 0)
    rng = np.random.default_rng(11)
    B, C, L = 4, 16, 32
    q, k, v = _qkv(rng, B, C, cfg_t)
    hd = cfg_t.head_dim
    start = np.asarray([0, 5, 13, 9], np.int32)
    ntok = np.asarray([16, 3, 1, 7], np.int32)
    active = np.asarray([True, True, True, False])
    j = np.arange(C)[None, :]
    pos = (start[:, None] + j).astype(np.int32)
    qpos = start[:, None] + np.minimum(j, ntok[:, None] - 1)
    kw = dict(positions=pos, mask=_mask(qpos, L, cfg_t.sliding_window),
              cache_index=start, chunk_lens=ntok, active=active)
    length = WIN if kind == "ring" else L
    if layout == "contiguous":
        cache = rng.normal(size=(B, length, 1, hd)).astype(np.float32)
        caches = _both({"k": cache, "v": cache + 1.0})
    else:
        bs = int(layout.split("bs")[1])
        width = -(-length // bs)
        rows = B * width + 3
        caches = _both({"k": _pools(rng, rows, bs, hd),
                        "v": _pools(rng, rows, bs, hd)})
        kw.update(page_table=_tables(rng, B, width, rows), page_len=length,
                  page_ring=kind == "ring")
    jkw, tkw = _kwargs(**kw)
    out = attend(cfg_j, cfg_t, q, k, v, dict(jkw, cache=caches[0]),
                 dict(tkw, cache=caches[1]))
    _same(out)


@pytest.mark.parametrize("layout", ["contiguous", "paged-bs4", "paged-bs16"])
@pytest.mark.parametrize("kind", ["ring", "global"])
def test_decode_matches_jax(attend, layout, kind):
    """Decode at positions below the window, at the wrap and past it, one
    row inactive (its write dropped, its region untouched).  Paged ring
    rows write at idx mod window through K1's plain version, as JAX's
    paged kernel does."""
    cfg_j, cfg_t = _local(*_configs(), WIN if kind == "ring" else 0)
    rng = np.random.default_rng(12)
    B, L = 4, 32
    q, k, v = _qkv(rng, B, 1, cfg_t)
    hd = cfg_t.head_dim
    idx = np.asarray([3, WIN, 21, 30], np.int32)
    active = np.asarray([True, True, False, True])
    kw = dict(positions=idx[:, None], cache_index=idx, active=active,
              mask=_mask(idx[:, None], L, cfg_t.sliding_window))
    length = WIN if kind == "ring" else L
    if layout == "contiguous":
        cache = rng.normal(size=(B, length, 1, hd)).astype(np.float32)
        caches = _both({"k": cache, "v": cache - 1.0})
    else:
        bs = int(layout.split("bs")[1])
        width = -(-length // bs)
        rows = B * width + 2
        caches = _both({"k": _pools(rng, rows, bs, hd),
                        "v": _pools(rng, rows, bs, hd)})
        kw.update(page_table=_tables(rng, B, width, rows), page_len=length,
                  page_ring=kind == "ring")
    jkw, tkw = _kwargs(**kw)
    before = {n: c.clone() for n, c in caches[1].items()}
    out = attend(cfg_j, cfg_t, q, k, v, dict(jkw, cache=caches[0]),
                 dict(tkw, cache=caches[1]))
    _same(out)
    if layout == "contiguous":              # the inactive row's region
        for n, c in out[1][2].items():
            np.testing.assert_array_equal(c[2], before[n][2].numpy())


# -- PagedKV ------------------------------------------------------------------
def test_paged_kv_ring_accounting_matches_jax():
    """A random admit / ensure / release schedule on a global pool and a
    ring pool that each run short: every decision, table and free count as
    JAX's PagedKV makes it."""
    rng = np.random.default_rng(21)
    B, max_len, bs = 4, 48, 4
    args = (B, max_len, bs, 30, WIN, 5)
    jkv, tkv = JKV(*args), TKV(*args)
    live = {}
    for _ in range(200):
        slot = int(rng.integers(B))
        if slot in live:
            if rng.random() < 0.3:
                assert tkv.release(slot) == tuple(map(list,
                                                      jkv.release(slot)))
                del live[slot]
            else:
                plen, new, pos = live[slot]
                if pos < min(plen + new - 1, max_len):
                    assert tkv.ensure(slot, pos) == jkv.ensure(slot, pos)
                    live[slot] = (plen, new, pos + 1)
        else:
            plen = int(rng.integers(1, max_len))
            new = int(rng.integers(1, 12))
            assert tkv.needs(plen, new) == jkv.needs(plen, new)
            assert tkv.fits(plen, new) == jkv.fits(plen, new)
            assert tkv.can_admit(plen, new) == jkv.can_admit(plen, new)
            ok = tkv.admit(slot, plen, new)
            assert ok == jkv.admit(slot, plen, new)
            if ok:
                live[slot] = (plen, new, plen)
        for t, j in zip(tkv.gather_tables(), jkv.gather_tables()):
            np.testing.assert_array_equal(t, j)
        for s in range(B):
            for t, j in zip(tkv.scatter_rows(s), jkv.scatter_rows(s)):
                np.testing.assert_array_equal(t, j)
        for name in ("pool_g", "pool_l"):
            pt, pj = getattr(tkv, name), getattr(jkv, name)
            assert (pt.num_free, pt.num_reserved) == \
                (pj.num_free, pj.num_reserved)
        tkv.check()
    assert (tkv.zero_block_g, tkv.zero_block_l, tkv.width_l) == \
        (jkv.zero_block_g, jkv.zero_block_l, jkv.width_l)


# -- engines ------------------------------------------------------------------
def _specs():
    """Staggered requests whose positions pass the window (every ring
    wraps); one prompt of 30 streams as chunks of 16 over window 8."""
    rng = np.random.default_rng(3)
    out = []
    for i, (plen, new) in enumerate([(11, 8), (3, 9), (20, 6), (7, 10),
                                     (30, 7)]):
        kw = dict(prompt=rng.integers(0, 512, plen).astype(np.int32),
                  max_new=new, seed=100 + i)
        if i in (1, 3):
            kw.update(temperature=0.8, top_k=40)
        out.append(kw)
    return out


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
        out.append((np.asarray(lv), np.asarray(sc), np.asarray(x)))
        return lv, sc

    mod.quant_levels = quant
    try:
        yield
    finally:
        mod.quant_levels = orig


@pytest.fixture(scope="module")
def served(models):
    """JAX's contiguous engine (op by op, its DAC levels recorded), then
    the port's contiguous and paged engines, each free-running and
    replaying JAX's levels."""
    cfg_j, params_j, cfg_t, params_t = models
    runs = {}
    lv = []
    with jax.disable_jit(), _levels(jel, lv):
        ej = JEng(cfg_j, params_j, fresh_noise=False, **ENGINE)
        runs["jax"] = (ej, ej.serve([JReq(**s) for s in _specs()],
                                    stagger=2), lv)
    for paged in (False, True):
        for replay in (None, [(a, b) for a, b, _ in lv]):
            et = TEng(cfg_t, params_t, fresh_noise=False, paged=paged,
                      device="cpu", **ENGINE)
            lt = []
            with _levels(tel, lt, replay):
                res = et.serve([TReq(**s) for s in _specs()], stagger=2)
            tag = ("paged" if paged else "contiguous") + \
                ("/replay" if replay is not None else "")
            runs[tag] = (et, res, lt)
    return runs


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_ring_engines_serve_jax_tokens(served, layout):
    ej, rj, _ = served["jax"]
    et, rt, _ = served[layout]
    assert [r.rid for r in rt] == [r.rid for r in rj] == list(range(5))
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.tokens, a.tokens,
                                      err_msg=f"rid {a.rid}")
        assert (b.done_reason, b.steps) == (a.done_reason, a.steps)
    mj, mt = ej.metrics(), et.metrics()
    for k in ("steps", "peak_concurrent", "prefill_tokens_total"):
        assert mt[k] == mj[k], k
    assert mt["kv_reads_total"] == mj["kv_reads_total"]
    assert et.energy_conserved(rt)
    assert max(len(s["prompt"]) + s["max_new"] for s in _specs()) > 4 * WIN
    if layout == "paged":
        assert et.kv.pool_l.num_blocks == 3 and et.kv.width_l == 1
        et.kv.check()
        assert et.kv.pool_l.num_free == et.kv.pool_l.num_blocks


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_ring_engine_ledgers_match_on_jax_dac_levels(served, layout):
    """Replaying JAX's DAC levels, per-request, prefill, idle and total
    energy agree within rtol 1e-5, and the tokens stay JAX's."""
    ej, rj, _ = served["jax"]
    et, rt, _ = served[f"{layout}/replay"]
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.energy_pj, a.energy_pj, rtol=1e-5)
        np.testing.assert_allclose(b.prefill_energy_pj, a.prefill_energy_pj,
                                   rtol=1e-5)
    for k in ("total_energy_pj", "idle_energy_pj"):
        np.testing.assert_allclose(getattr(et, k), getattr(ej, k), rtol=1e-5)
    assert et.energy_conserved(rt) and ej.energy_conserved(rj)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_free_running_levels_differ_only_at_rounding_ties(served, layout):
    """On its own the port computes every projection input to float32
    order; a level that differs from JAX's sits at a rounding tie (x /
    scale within 1e-4 of k + 0.5), and every projection before the first
    such flip has JAX's levels exactly."""
    _, _, lv_j = served["jax"]
    _, _, lv_t = served[layout]
    assert len(lv_t) == len(lv_j)
    for c, ((lj, sj, xj), (lt, _, _)) in enumerate(zip(lv_j, lv_t)):
        if np.array_equal(lj, lt):
            continue
        xs = np.abs(xj / sj)
        assert np.abs(xs - np.floor(xs) - 0.5)[lj != lt].max() < 1e-4, c
        break


def test_cancel_mid_decode_frees_and_zeroes_the_ring(models):
    """Cancel a request mid-decode (after its ring wrapped) on both
    layouts: its result carries the partial tokens and energy, the rest
    finish, energy is conserved and every block and region is zero."""
    _, _, cfg, params = models
    rng = np.random.default_rng(5)
    for paged in (False, True):
        eng = TEng(cfg, params, fresh_noise=False, paged=paged, device="cpu",
                   **ENGINE)
        rids = [eng.submit(TReq(prompt=rng.integers(0, 512, n)
                                .astype(np.int32), max_new=12))
                for n in (10, 4, 6)]
        for _ in range(5):
            eng.step()
        sid = eng.scheduler.slot_of(rids[0])
        assert eng.scheduler.slots[sid].pos > WIN
        assert not eng.scheduler.slots[sid].prefilling
        live = eng.cancel(rids[0])
        assert live.done_reason == "cancelled" and 0 < len(live.tokens) < 12
        rest = eng.drain()
        assert sorted(r.rid for r in rest) == rids[1:]
        assert eng.energy_conserved(rest + [live])
        if paged:
            eng.kv.check()
            assert eng.kv.pool_l.num_free == eng.kv.pool_l.num_blocks
        for blk in eng.cache.values():
            assert all(float(t.abs().max()) == 0.0 for t in blk.values())


def test_retired_ring_blocks_and_regions_zeroed(models):
    """While one request still decodes, the slot or blocks of one that
    retired are zero (global blocks and ring blocks, or the slot's
    contiguous region and ring), as JAX's test_serve_continuous and
    test_kv_paged require; the live request's are not."""
    _, _, cfg, params = models
    rng = np.random.default_rng(6)
    for paged in (False, True):
        eng = TEng(cfg, params, fresh_noise=False, paged=paged, device="cpu",
                   **ENGINE)
        eng.submit(TReq(prompt=rng.integers(0, 512, 12).astype(np.int32),
                        max_new=3))
        eng.submit(TReq(prompt=rng.integers(0, 512, 5).astype(np.int32),
                        max_new=14))
        eng.step()
        assert eng.scheduler.num_active == 2
        while eng.scheduler.num_active == 2:
            if paged:
                held = (eng.kv.table_g[0].copy(), eng.kv.table_l[0].copy())
            eng.step()
        assert eng.scheduler.slots[0] is None
        for name, blk in eng.cache.items():
            for key, t in blk.items():
                if not paged:
                    assert float(t[0].abs().max()) == 0.0, (name, key)
                    assert float(t[1].abs().max()) > 0.0, (name, key)
                    continue
                ring = name in eng.ring
                ids = held[1] if ring else held[0]
                ids = ids[ids >= 0]
                assert float(t[torch.from_numpy(ids)].abs().max()) == 0.0
        eng.drain()


def test_admission_queues_on_a_small_ring_pool(models, served):
    """num_ring_blocks=1: each request holds one ring block, so one runs
    at a time though three slots are free; every request still gets the
    tokens it gets sharing the batch (frozen noise, per-row DAC scale)."""
    _, _, cfg, params = models
    eng = TEng(cfg, params, fresh_noise=False, paged=True, num_ring_blocks=1,
               device="cpu", **ENGINE)
    specs = [s for s in _specs() if "temperature" not in s]
    rids = [eng.submit(TReq(**s)) for s in specs]
    eng.step()
    assert eng.scheduler.num_active == 1
    assert eng.scheduler.pending == len(specs) - 1
    got = {r.rid: r.tokens for r in eng.drain()}
    assert eng.metrics()["peak_concurrent"] == 1
    shared = {i: r.tokens for i, r in enumerate(served["paged"][1])
              if "temperature" not in _specs()[i]}
    for rid, i in zip(rids, sorted(shared)):
        np.testing.assert_array_equal(got[rid], shared[i])
    with pytest.raises(ValueError, match="KV blocks"):
        TEng(cfg, params, paged=True, num_ring_blocks=0, device="cpu",
             **ENGINE).submit(TReq(prompt=np.ones(4, np.int32)))


# -- on the card --------------------------------------------------------------
@pytest.mark.gpu
def test_k1_on_a_wrapped_ring_table_matches_float64_plain():
    """K1 on ring tables of the full-width gemma3-1b shapes (window 512,
    block 16, T 32) and of the smoke window (8 in one block of 16, its
    upper half masked): rows that wrapped, writes mid-block, a mask with a
    hole (not a prefix), an inactive row.  Within 1e-5 of the float64
    plain version; the pools bit-identical after the write."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as k1
    from repro_torch.kernels.ref import NEG_INF
    from repro_torch.models.attention import _ring_positions
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for win, bs, G, hd in ((512, 16, 4, 256), (WIN, 16, 4, 16)):
        B, T = 4, -(-win // bs)
        rows = B * T + 3
        kp = torch.randn((rows + 1, bs, 1, hd), generator=gen, device=dev)
        vp = torch.randn((rows + 1, bs, 1, hd), generator=gen, device=dev)
        kp[rows] = 0.0
        vp[rows] = 0.0
        table = torch.randperm(rows, generator=gen, device=dev)[:B * T]
        table = table.reshape(B, T).to(torch.int32)
        idx = torch.tensor([win + 37, 3 * win + 5, win - 2, 2 * win + 9],
                           device=dev)
        mask = torch.where(_ring_positions(idx, win) >= 0, 0.0, NEG_INF)
        mask[1, win // 3:win // 2] = NEG_INF             # a hole
        active = torch.tensor([True, True, True, False], device=dev)
        q = torch.randn((B, 1, G, hd), generator=gen, device=dev)
        kn = torch.randn((B, 1, hd), generator=gen, device=dev)
        vn = torch.randn((B, 1, hd), generator=gen, device=dev)
        kp2, vp2 = kp.double().cpu(), vp.double().cpu()
        before = k1.paged_attention_decode.launches
        out, _, _ = ops.paged_attention_decode(
            q, kp, vp, table, mask, kn, vn, torch.remainder(idx, win),
            active)
        assert k1.paged_attention_decode.launches == before + 1
        ref, _, _ = ops.paged_attention_decode(
            q.double().cpu(), kp2, vp2, table.cpu(),
            mask.double().cpu(), kn.double().cpu(), vn.double().cpu(),
            torch.remainder(idx, win).cpu(), active.cpu())
        err = (out.double().cpu() - ref).abs().max() / ref.abs().max()
        assert err <= 1e-5, (win, float(err))
        assert torch.equal(kp.double().cpu(), kp2)
        assert torch.equal(vp.double().cpu(), vp2)


@pytest.mark.gpu
def test_ring_engines_serve_on_the_card():
    """The smoke ring stack served on the card, paged (K1 on ring and
    global tables, K2 on the global layer, K3) and contiguous (K3 only):
    every request finishes with its tokens, energy is conserved, and only
    the paged run launches K1 and K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import paged_attention as k1
    from repro_torch.kernels import paged_prefill as k2
    _, cfg = _configs()
    params = tlm.init_model_params(cfg, 0)
    specs = [s for s in _specs() if "temperature" not in s]
    for paged in (False, True):
        eng = TEng(cfg, params, fresh_noise=False, paged=paged, **ENGINE)
        before = (k1.paged_attention_decode.launches,
                  k2.paged_prefill.launches)
        res = eng.serve([TReq(**s) for s in specs], stagger=2)
        grew = [a > b for a, b in zip((k1.paged_attention_decode.launches,
                                       k2.paged_prefill.launches), before)]
        assert grew == [paged, paged]
        assert [len(r.tokens) for r in res] == [s["max_new"] for s in specs]
        assert eng.energy_conserved(res)
