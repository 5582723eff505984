"""Port parity of the recurrent stacks end to end: xlstm-350m (mLSTM and
sLSTM blocks, analog) and jamba-v0.1-52b (mamba, attention and mixture of
experts, the "mixed" placement) through ``repro_torch.models.lm`` and
``repro_torch.serve.ServingEngine`` against the JAX package on identical
weights, at smoke widths (float32, per-row DAC scale, frozen noise); jamba's
smoke stack is cut from 8 to its first 4 layers (mamba, mamba with MoE,
mamba, attention with MoE), which hold every block kind it has.  JAX's
steps run jitted, their DAC levels recorded by ordered host callbacks.

* Shapes: ``lm.specs`` (paths and shapes; nothing allocated),
  ``layer_paths`` and ``placement_plan`` of the full published configs
  equal JAX's.
* Model steps: the legacy prefill into a contiguous cache and decode steps
  with an idle row, against JAX's: logits within 1e-4, states within 1e-5,
  energy within rtol 1e-5, on DAC levels replayed from the JAX run; the
  idle row's state is left as it was, bit for bit.
* Engines (legacy bucketed prefill, the only one these stacks take):
  temperature-0 token streams identical to JAX's contiguous engine, on the
  contiguous layout and, for jamba, the paged one (xlstm asked for paging
  stays contiguous, as in JAX's engine); ledgers within
  rtol 1e-5 on runs that replay JAX's levels; every retired slot's state
  row zeroed, and a slot reused after a retirement serving a request as a
  fresh engine does.
* Refusals as JAX's: chunked prefill, the prefix cache and speculation.
* A fact of the reference, held: xlstm's prefill is finite and agrees at
  64 prompt positions and is NaN at 128 in both packages, at the same
  logits (``repro/models/xlstm.py:74``: exp of the intra-chunk decay
  overflows before the causal mask multiplies it by 0).
"""
import contextlib
import io

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
from repro.serve.spec import ServeSpec as JSpec
from repro_torch.core import emt_linear as tel
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx
from repro_torch.serve.engine import GenRequest as TReq
from repro_torch.serve.engine import ServingEngine as TEng
from repro_torch.serve.spec import ServeSpec as TSpec

XLSTM, JAMBA = "xlstm-350m", "jamba-v0.1-52b"
PLACE = {XLSTM: dict(mode="analog"),
         JAMBA: dict(placement="mixed", model_overrides={"num_layers": 4})}
CORNERS = {XLSTM: {"analog"}, JAMBA: {"pcm", "rram", "sram_digital"}}
ENGINE = dict(batch_size=3, max_len=40, seed=7, block_size=8)
LOGIT_TOL, STATE_TOL = 1e-4, 1e-5


def _spec(mod, arch, smoke=True):
    return mod(arch=arch, a_per_row=True, frozen_noise=True, smoke=smoke,
               **PLACE[arch])


def _models(arch):
    cfg_j = _spec(JSpec, arch).build_config()
    params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
    cfg_t = _spec(TSpec, arch).build_config()
    params_t = tlm.load_jax_arrays(_tree_to_arrays(params_j), cfg_t,
                                   device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module", params=[XLSTM, JAMBA])
def models(request):
    return (request.param,) + _models(request.param)


@contextlib.contextmanager
def _jax_levels(out):
    """Record every projection's DAC (levels, scale) of JAX's jitted steps
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


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
@pytest.mark.parametrize("place", [dict(mode="analog"),
                                   dict(placement="mixed")],
                         ids=["analog", "mixed"])
def test_full_config_specs_paths_and_plan_match_jax(arch, place):
    """The published configs (24 xLSTM blocks, 7:1 mLSTM:sLSTM; 32 jamba
    layers, 1:7 attention:mamba, MoE every other layer): parameter paths
    and shapes, placement paths and the resolved plan equal JAX's."""
    cj = JSpec(arch=arch, smoke=False, **place).build_config()
    ct = TSpec(arch=arch, smoke=False, **place).build_config()
    assert ct.blocks() == cj.blocks()
    assert ct.moe_layer_mask() == cj.moe_layer_mask()
    assert (ct.dt_rank, ct.d_inner) == (cj.dt_rank, cj.d_inner)
    assert _shapes(tlm.specs(ct)) == _shapes(jlm.specs(cj))
    assert ct.layer_paths() == cj.layer_paths()
    assert ct.placement_plan() == cj.placement_plan()


def test_recurrent_kv_state_shapes_match_jax(models):
    """Contiguous and paged caches: attention layers as before, every
    recurrent layer (batch, ...) state rows of JAX's shapes and dtypes."""
    arch, cfg_j, _, cfg_t, _ = models
    for j, t in ((jlm.init_cache(cfg_j, 3, 40),
                  tlm.init_cache(cfg_t, 3, 40, device="cpu")),
                 (jlm.init_paged_cache(cfg_j, 3, 40, 8, 15),
                  tlm.init_paged_cache(cfg_t, 3, 40, 8, 15, device="cpu"))):
        assert _shapes(t) == _shapes(j)
        for name, blk in t.items():
            for key, v in blk.items():
                assert str(v.dtype).split(".")[-1] == \
                    str(j[name][key].dtype), (name, key)
    assert tlm.recurrent_layers(cfg_t) == frozenset(
        f"layer_{i:03d}" for i, k in enumerate(cfg_t.blocks())
        if k != "attn")


def _np_cache(c):
    """A copy (the port's steps update their cache in place)."""
    return {n: {k: np.array(v) for k, v in blk.items()}
            for n, blk in c.items()}


def test_prefill_and_decode_steps_match_jax(models):
    """A legacy prefill (batch 2, left-padded as the engine pads: 5 pad
    tokens before an 11-token prompt in a 16 bucket) into a contiguous
    cache, then a decode step with row 1 idle: logits, caches and energy
    against JAX's on replayed DAC levels; the idle row's state and K/V
    untouched."""
    arch, cfg_j, params_j, cfg_t, params_t = models
    B, L, S = 2, 40, 16
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    toks[1, :5] = 0
    act = np.asarray([True, False])
    pos = np.asarray([S, S])
    lv = []
    out_j = []
    prefill = jax.jit(lambda p, t, c: jlm.prefill(
        p, {"tokens": t}, cfg_j, JCtx(seed=jnp.uint32(7)), c))
    decode = jax.jit(lambda p, c, t, i, a: jlm.decode_step(
        p, c, t, i, cfg_j, JCtx(seed=jnp.uint32(7)), active=a))
    with _jax_levels(lv):
        c, lg, a = prefill(params_j, jnp.asarray(toks),
                           jlm.init_cache(cfg_j, B, L))
        out_j.append((lg, a, _np_cache(c)))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        lg, c, a = decode(params_j, c, tok, jnp.asarray(pos),
                          jnp.asarray(act))
        out_j.append((lg, a, _np_cache(c)))
    out_t = []
    with _levels(tel, [], replay=list(lv)):
        c = tlm.init_cache(cfg_t, B, L, device="cpu")
        c, lg, a = tlm.prefill(params_t, {"tokens": torch.from_numpy(
            toks).long()}, cfg_t, TCtx(seed=7), c)
        out_t.append((lg, a, _np_cache(c)))
        before = _np_cache(c)
        lg, c, a = tlm.decode_step(params_t, c, lg.argmax(-1),
                                   torch.from_numpy(pos), cfg_t,
                                   TCtx(seed=7), active=torch.from_numpy(act))
        out_t.append((lg, a, _np_cache(c)))
    for name, blk in c.items():                 # row 1 idle in the decode
        for key, v in blk.items():
            np.testing.assert_array_equal(v[1].numpy(), before[name][key][1])
    for (lj, aj, cj), (lt, at, ct) in zip(out_j, out_t):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(lj, -1)))
        for key in ("energy_pj", "reads", "kv_reads"):
            np.testing.assert_allclose(float(at[key]), float(aj[key]),
                                       rtol=1e-5, err_msg=key)
        assert set(at["corners"]) == set(aj["corners"]) == CORNERS[arch]
        for name, blk in ct.items():
            for key, v in blk.items():
                np.testing.assert_allclose(v, cj[name][key], rtol=0,
                                           atol=STATE_TOL,
                                           err_msg=f"{name}/{key}")


def _requests(Req):
    rng = np.random.default_rng(3)
    return [Req(prompt=rng.integers(0, 512, plen).astype(np.int32),
                max_new=3 + i, seed=100 + i)
            for i, plen in enumerate([11, 5, 20, 7, 14])]


def _same_tokens(ra, rb):
    assert [r.rid for r in ra] == [r.rid for r in rb] == list(range(5))
    for a, b in zip(ra, rb):
        np.testing.assert_array_equal(b.tokens, a.tokens,
                                      err_msg=f"rid {a.rid}")
        assert (b.done_reason, b.steps) == (a.done_reason, a.steps)


def _same_ledgers(arch, ea, ra, eb, rb):
    for a, b in zip(ra, rb):
        np.testing.assert_allclose(b.energy_pj, a.energy_pj, rtol=1e-5)
        np.testing.assert_allclose(b.prefill_energy_pj, a.prefill_energy_pj,
                                   rtol=1e-5)
    ma, mb = ea.metrics(), eb.metrics()
    for k in ("total_energy_pj", "idle_energy_pj"):
        np.testing.assert_allclose(mb[k], ma[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(mb["kv_reads_total"], ma["kv_reads_total"],
                               rtol=1e-6)
    for k in ("steps", "peak_concurrent", "prefill_tokens_total"):
        assert mb[k] == ma[k], k
    assert set(mb["corner_energy_pj"]) == set(ma["corner_energy_pj"]) \
        == CORNERS[arch]
    for name, v in ma["corner_energy_pj"].items():
        np.testing.assert_allclose(mb["corner_energy_pj"][name], v,
                                   rtol=1e-5, err_msg=name)
    assert eb.energy_conserved(rb) and ea.energy_conserved(ra)


@pytest.fixture(scope="module")
def served(models):
    """JAX's contiguous engine (its levels recorded), then the port's
    engines on both layouts, free-running and replaying them."""
    arch, cfg_j, params_j, cfg_t, params_t = models
    lv = []
    with _jax_levels(lv):
        ej = JEng(cfg_j, params_j, fresh_noise=False, **ENGINE)
        runs = {"jax": (ej, ej.serve(_requests(JReq), stagger=2))}
    for paged in (False, True):
        for replay in (None, list(lv)):
            et = TEng(cfg_t, params_t, fresh_noise=False, paged=paged,
                      device="cpu", **ENGINE)
            with _levels(tel, [], replay):
                res = et.serve(_requests(TReq), stagger=2)
            if replay is not None:
                assert not replay               # every level consumed
            runs[("paged" if paged else "contiguous")
                 + ("/replay" if replay is not None else "")] = (et, res)
    return arch, runs


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_serves_jax_tokens_and_ledgers(served, layout):
    """Left-padded power-of-two buckets (4 to 32) admitted alone and
    copied into the slot's state rows (and, jamba, its K/V region or
    blocks), then decoded together: JAX's tokens free-running, JAX's
    ledgers on its levels."""
    arch, runs = served
    ej, rj = runs["jax"]
    et, rt = runs[layout]
    assert not et.chunked and not ej.chunked and not ej.paged
    assert et.paged == (arch == JAMBA and layout == "paged")
    _same_tokens(rj, rt)
    assert et.energy_conserved(rt)
    ep, rp = runs[f"{layout}/replay"]
    _same_tokens(rj, rp)
    _same_ledgers(arch, ej, rj, ep, rp)
    if et.paged:
        et.kv.check()
        assert et.kv.pool_g.num_free == et.kv.pool_g.num_blocks


def test_retired_state_rows_are_zeroed(served):
    """After the run every slot has retired: every state row, K/V region
    and block of the port's caches is zero (JAX's are too)."""
    arch, runs = served
    for key in ("contiguous", "paged", "jax"):
        eng = runs[key][0]
        for name, blk in eng.cache.items():
            for k, v in blk.items():
                assert float(np.abs(np.asarray(v)).max()) == 0.0, \
                    (key, name, k)


def test_reused_slot_serves_as_a_fresh_engine(models):
    """One slot: a request served after another in the same slot gives
    the tokens and energy it gets on a fresh engine (the first request's
    state rows were zeroed at its retirement)."""
    arch, _, _, cfg_t, params_t = models
    kw = dict(ENGINE, batch_size=1, paged=arch == JAMBA)
    reqs = _requests(TReq)
    eng = TEng(cfg_t, params_t, fresh_noise=False, device="cpu", **kw)
    first = eng.serve(reqs[2:4], stagger=0)
    fresh = TEng(cfg_t, params_t, fresh_noise=False, device="cpu", **kw)
    alone = fresh.serve([reqs[3]], stagger=0)
    np.testing.assert_array_equal(first[1].tokens, alone[0].tokens)
    np.testing.assert_allclose(first[1].energy_pj, alone[0].energy_pj,
                               rtol=1e-6)


def _refusal(make):
    with pytest.raises(ValueError) as exc:
        make()
    return str(exc.value)


def test_chunked_prefill_prefix_cache_and_speculation_refuse(models):
    """As JAX's engine does: chunked prefill (engine and model step), the
    prefix cache (it needs chunked prefill) and speculative decoding (its
    verify is a chunk step) refuse these stacks with ValueError."""
    arch, cfg_j, params_j, cfg_t, params_t = models
    jkw = dict(ENGINE, paged=True)
    tkw = dict(jkw, device="cpu")
    for kw_j, kw_t in ((dict(jkw, chunked_prefill=True),
                        dict(tkw, chunked_prefill=True)),
                       (dict(jkw, prefix_cache=True),
                        dict(tkw, prefix_cache=True))):
        mj = _refusal(lambda: JEng(cfg_j, params_j, **kw_j))
        mt = _refusal(lambda: TEng(cfg_t, params_t, **kw_t))
        assert mt.split(" ")[:2] == mj.split(" ")[:2], (mj, mt)
    tok = np.zeros((2, 4), np.int32)
    start = ntok = np.asarray([0, 4], np.int32)
    mj = _refusal(lambda: jlm.chunk_step(
        params_j, jlm.init_cache(cfg_j, 2, 16), jnp.asarray(tok),
        jnp.asarray(start), jnp.asarray(ntok), cfg_j, JCtx()))
    mt = _refusal(lambda: tlm.chunk_step(
        params_t, tlm.init_cache(cfg_t, 2, 16, device="cpu"),
        torch.from_numpy(tok).long(), torch.from_numpy(start).long(),
        torch.from_numpy(ntok).long(), cfg_t, TCtx()))
    assert mt == mj and "attention-only" in mt
    for mod, dev in ((JSpec, {}), (TSpec, {"torch_device": "cpu"})):
        spec = _spec(mod, arch).replace(draft_placement="sram_digital",
                                        max_len=32, temperature=0.0)
        msg = _refusal(lambda: spec.build_engine(**dev))
        assert "chunked prefill" in msg, msg


def test_mlstm_prefill_nan_at_128_positions_as_in_jax():
    """A fact of the reference, mirrored: xlstm's prefill (smoke width) is
    finite and agrees with JAX's at 64 prompt positions; at 128 (one mLSTM
    chunk of 128) exp of the intra-chunk decay overflows to inf before the
    causal mask multiplies it by 0 (``repro/models/xlstm.py:74``), and
    both packages give non-finite logits at the same positions.  The
    legacy engine pads every prompt of 65-128 tokens into the 128 bucket,
    so such a prompt is hit in both."""
    cfg_j, params_j, cfg_t, params_t = _models(XLSTM)
    rng = np.random.default_rng(5)
    prefill = jax.jit(lambda p, t, c: jlm.prefill(
        p, {"tokens": t}, cfg_j, JCtx(seed=jnp.uint32(7)), c)[1])
    for S in (64, 128):
        toks = rng.integers(0, cfg_t.vocab_size, (2, S)).astype(np.int32)
        lv = []
        with _jax_levels(lv):
            lj = prefill(params_j, jnp.asarray(toks),
                         jlm.init_cache(cfg_j, 2, S))
        with _levels(tel, [], replay=list(lv)):
            _, lt, _ = tlm.prefill(params_t, {"tokens": torch.from_numpy(
                toks).long()}, cfg_t, TCtx(seed=7),
                tlm.init_cache(cfg_t, 2, S, device="cpu"))
        lj, lt = np.asarray(lj), lt.numpy()
        if S == 64:
            assert np.isfinite(lj).all() and np.isfinite(lt).all()
            np.testing.assert_allclose(lt, lj, rtol=0, atol=LOGIT_TOL)
        else:
            assert not np.isfinite(lj).any()
            np.testing.assert_array_equal(np.isfinite(lt), np.isfinite(lj))


def test_train_loss_matches_jax(models):
    """The training forward (no cache: every mixer from a zero state) on a
    batch of 2 x 12: loss, cross-entropy, energy and the reg term equal
    JAX's on replayed levels."""
    arch, cfg_j, params_j, cfg_t, params_t = models
    rng = np.random.default_rng(2)
    toks, labels = (rng.integers(0, cfg_t.vocab_size, (2, 12)).astype(
        np.int32) for _ in range(2))
    lv = []
    # without remat: jax.checkpoint turns the aux's layer count into a
    # tracer, which the rho_mean metric cannot take; no value changes
    loss = jax.jit(lambda p, t, y: jlm.train_loss(
        p, {"tokens": t, "labels": y}, cfg_j.replace(remat=False),
        JCtx(seed=jnp.uint32(3)), lam=1e-6)[1])
    with _jax_levels(lv):
        mj = loss(params_j, jnp.asarray(toks), jnp.asarray(labels))
    with _levels(tel, [], replay=list(lv)):
        _, mt = tlm.train_loss(params_t, {
            "tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labels).long()}, cfg_t,
            TCtx(seed=3), lam=1e-6)
    for key in ("loss", "ce", "energy_uj", "reg", "aux_loss"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


def test_launcher_serves_the_recurrent_stacks_on_the_cpu():
    """``launch.serve --arch xlstm-350m`` and ``--arch jamba-v0.1-52b
    --placement mixed --paged``: the legacy prefill path, every request
    served; jamba's paged attention plan lists its attention layer only."""
    from repro_torch.launch import serve as tserve
    tiny = ["--batch", "2", "--requests", "3", "--prompt-len", "6",
            "--max-new", "3", "--frozen-noise", "--stagger", "1"]
    for argv in (["--arch", XLSTM], ["--arch", JAMBA, "--placement",
                                     "mixed", "--paged", "--block-size",
                                     "4"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tserve.main(argv + tiny, torch_device="cpu")
        out = buf.getvalue()
        assert "prefill path: legacy" in out, out
        assert "served 3 requests / 9 tokens" in out, out
    assert "paged attention paths (1 layers)" in out
    assert "dec/layer_003/attn (attn)" in out

