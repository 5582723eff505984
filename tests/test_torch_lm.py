"""Port parity: the shrunk gemma3-1b decoder (2 layers, d_model 64, f32,
analog, all-global, per-row DAC scale, frozen noise) on the paged cache,
JAX weights carried across by the numpy bridge.

Tolerances: logits within 1e-4 absolute (float32, |logit| < 1); greedy
tokens identical over 16 decode steps; pools after the chunk step within
1e-5 (K/V projections of a 2-layer stack, float32 order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro.nn.param import init_params
from repro.serve.kv_pool import PagedKV as JKV
from repro.serve.spec import ServeSpec
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx
from repro_torch.serve.kv_pool import PagedKV as TKV
from repro_torch.serve.spec import build_config

B, MAX_LEN, BS, C = 3, 48, 8, 8


@pytest.fixture(scope="module")
def models():
    cfg_j = ServeSpec(arch="gemma3-1b", mode="analog", smoke=True,
                      all_global=True, a_per_row=True).build_config() \
        .replace(num_layers=2)
    params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
    arrays = _tree_to_arrays(params_j)
    cfg_t = build_config(smoke=True, all_global=True, a_per_row=True,
                         model_overrides={"num_layers": 2})
    params_t = tlm.load_jax_arrays(arrays, cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t, arrays


def test_config_mirrors_servespec(models):
    cfg_j, _, cfg_t, _, _ = models
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "rope_theta", "sliding_window",
              "qk_norm", "tie_embeddings", "embed_scale", "norm_eps", "act",
              "layer_pattern"):
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    assert cfg_t.emt.quant.a_per_row and cfg_j.emt.quant.a_per_row
    assert cfg_t.emt.device.state_offsets == cfg_j.emt.device.state_offsets


def test_bridge_rejects_bad_trees(models):
    _, _, cfg_t, _, arrays = models
    missing = dict(arrays)
    missing.pop("decoder/layer_001/attn/wq/w")
    with pytest.raises(KeyError, match="missing"):
        tlm.load_jax_arrays(missing, cfg_t, device="cpu")
    extra = dict(arrays, **{"decoder/layer_009/attn/wq/w": np.zeros(1)})
    with pytest.raises(KeyError, match="layer_009"):
        tlm.load_jax_arrays(extra, cfg_t, device="cpu")
    bad = dict(arrays)
    bad["embed/table"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tlm.load_jax_arrays(bad, cfg_t, device="cpu")


def test_seeded_init_full_width_specs_and_determinism(monkeypatch):
    """Full-width gemma3-1b has the published matrix sizes (embed/unembed
    301,989,888 + 26 x 26,836,992); the seeded init is deterministic; entry
    points default to the card and refuse to fall back to the CPU."""
    cfg = build_config(smoke=False, all_global=True, a_per_row=True)
    from repro_torch.utils.pytrees import flatten_with_paths
    mats = sum(int(np.prod(s.shape))
               for _, s in flatten_with_paths(tlm.specs(cfg))
               if len(s.shape) == 2)
    assert mats == 301_989_888 + 26 * 26_836_992
    small = build_config(smoke=True, all_global=True,
                         model_overrides={"num_layers": 2})
    a = tlm.init_model_params(small, 5, device="cpu")
    b = tlm.init_model_params(small, 5, device="cpu")
    assert torch.equal(a["embed"]["table"], b["embed"]["table"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.init_model_params(small, 5)


def test_chunk_and_decode_logits_and_greedy_tokens_match(models):
    cfg_j, params_j, cfg_t, params_t, _ = models
    nb = B * MAX_LEN // BS
    jkv, tkv = JKV(B, MAX_LEN, BS, nb), TKV(B, MAX_LEN, BS, nb)
    for s, plen in enumerate([13, 5, 9]):
        assert jkv.admit(s, plen, 30) and tkv.admit(s, plen, 30)
        for p in range(30):
            jkv.ensure(s, p)
            tkv.ensure(s, p)
    tg, tl = jkv.gather_tables()
    np.testing.assert_array_equal(tkv.gather_tables()[0], tg)
    cj = jlm.init_paged_cache(cfg_j, B, MAX_LEN, BS, nb)
    ct = tlm.init_paged_cache(cfg_t, B, MAX_LEN, BS, nb, device="cpu")
    jt = {"global": jnp.asarray(tg), "local": jnp.asarray(tl)}
    tt = {"global": torch.from_numpy(tg)}
    jlens = jlm.paged_lens(cfg_j, MAX_LEN)
    tlens = tlm.clamped_lens(tlm.paged_lens(cfg_t, MAX_LEN), MAX_LEN)
    assert tlens["global"] == jlens["global"]
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_t.vocab_size, (B, C)).astype(np.int32)
    start = np.zeros(B, np.int32)
    ntok = np.asarray([8, 5, 8], np.int32)
    act = np.asarray([True, True, False])        # row 2 inactive: no writes
    seed = 7
    lj, cj, aj = jlm.chunk_step(
        params_j, cj, jnp.asarray(tokens), jnp.asarray(start),
        jnp.asarray(ntok), cfg_j, JCtx(seed=jnp.uint32(seed)),
        active=jnp.asarray(act), page_tables=jt, page_lens=jlens)
    lt, ct, at = tlm.chunk_step(
        params_t, ct, torch.from_numpy(tokens).long(),
        torch.from_numpy(start).long(), torch.from_numpy(ntok).long(),
        cfg_t, TCtx(seed=seed), active=torch.from_numpy(act), page_tables=tt,
        page_lens=tlens)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)
    for name in cj:
        for k in ("k", "v"):
            np.testing.assert_allclose(ct[name][k].numpy(),
                                       np.asarray(cj[name][k]), rtol=0,
                                       atol=1e-5)
    for k in ("energy_pj", "kv_reads", "reg"):
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5)
    idx = ntok.astype(np.int64)
    act = np.asarray([True, True, True])
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for step in range(16):
        lj, cj, aj = jlm.decode_step(
            params_j, cj, jnp.asarray(tok), jnp.asarray(idx, jnp.int32),
            cfg_j, JCtx(seed=jnp.uint32(seed)), active=jnp.asarray(act),
            page_tables=jt, page_lens=jlens)
        lt, ct, at = tlm.decode_step(
            params_t, ct, torch.from_numpy(tok).long(),
            torch.from_numpy(idx), cfg_t, TCtx(seed=seed),
            active=torch.from_numpy(act), page_tables=tt, page_lens=tlens)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=1e-4, err_msg=f"step {step}")
        tj = np.asarray(jnp.argmax(lj, -1))
        np.testing.assert_array_equal(lt.argmax(-1).numpy(), tj,
                                      err_msg=f"step {step}")
        np.testing.assert_allclose(float(at["energy_pj"]),
                                   float(aj["energy_pj"]), rtol=1e-5)
        np.testing.assert_allclose(float(at["kv_reads"]),
                                   float(aj["kv_reads"]), rtol=1e-6)
        tok = tj.astype(np.int32)
        idx = idx + 1


def test_plain_attention_path_matches_jax_fallback(models):
    """fused_paged_attn=False (scatter + gather + _gqa_core) mirrors JAX's
    kill-switch fallback."""
    cfg_j, params_j, cfg_t, params_t, _ = models
    cfg_j = cfg_j.replace(fused_paged_attn=False)
    cfg_t = cfg_t.replace(fused_paged_attn=False)
    nb = B * MAX_LEN // BS
    kv = JKV(B, MAX_LEN, BS, nb)
    for s in range(B):
        assert kv.admit(s, 20, 4)
    tg, tl = kv.gather_tables()
    tg = tg[:, :4]
    lens_j = jlm.clamped_lens(jlm.paged_lens(cfg_j, MAX_LEN), 32)
    lens_t = tlm.clamped_lens(tlm.paged_lens(cfg_t, MAX_LEN), 32)
    cj = jlm.init_paged_cache(cfg_j, B, MAX_LEN, BS, nb)
    ct = tlm.init_paged_cache(cfg_t, B, MAX_LEN, BS, nb, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_t.vocab_size, (B, C)).astype(np.int32)
    start = np.asarray([0, 0, 0], np.int32)
    ntok = np.asarray([8, 3, 6], np.int32)
    lj, cj, _ = jlm.chunk_step(
        params_j, cj, jnp.asarray(tokens), jnp.asarray(start),
        jnp.asarray(ntok), cfg_j, JCtx(seed=jnp.uint32(3)),
        active=jnp.ones(B, bool),
        page_tables={"global": jnp.asarray(tg), "local": jnp.asarray(tl)},
        page_lens=lens_j)
    lt, ct, _ = tlm.chunk_step(
        params_t, ct, torch.from_numpy(tokens).long(),
        torch.from_numpy(start).long(), torch.from_numpy(ntok).long(), cfg_t,
        TCtx(seed=3), active=torch.ones(B, dtype=torch.bool),
        page_tables={"global": torch.from_numpy(tg)}, page_lens=lens_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    lj, _, _ = jlm.decode_step(
        params_j, cj, jnp.asarray(tok), jnp.asarray(ntok), cfg_j,
        JCtx(seed=jnp.uint32(3)), active=jnp.ones(B, bool),
        page_tables={"global": jnp.asarray(tg), "local": jnp.asarray(tl)},
        page_lens=lens_j)
    lt, _, _ = tlm.decode_step(
        params_t, ct, torch.from_numpy(tok).long(),
        torch.from_numpy(ntok).long(), cfg_t, TCtx(seed=3),
        active=torch.ones(B, dtype=torch.bool),
        page_tables={"global": torch.from_numpy(tg)}, page_lens=lens_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)


@pytest.mark.parametrize("all_global", [False, True])
def test_build_config_resolves_the_stack_as_servespec(all_global):
    """The published 5:1 local:global stack (smoke window 8) unless
    all_global coerces every layer to global attention, as
    ServeSpec.build_config resolves it; a prefix cache is refused on a
    stack that keeps ring layers, with JAX's message."""
    for smoke in (True, False):
        spec = ServeSpec(smoke=smoke, all_global=all_global, a_per_row=True)
        cfg_j = spec.build_config()
        cfg_t = build_config(smoke=smoke, all_global=all_global,
                             a_per_row=True)
        assert cfg_t.blocks() == cfg_j.blocks()
        assert cfg_t.sliding_window == cfg_j.sliding_window
        assert ("local" in cfg_t.blocks()) is not all_global
    assert build_config(smoke=False, all_global=all_global).sliding_window \
        == (0 if all_global else 512)
    if all_global:
        assert build_config(all_global=True, prefix_cache=True).blocks() == \
            ServeSpec(all_global=True, prefix_cache=True, paged=True) \
            .build_config().blocks()
        return
    with pytest.raises(ValueError) as jerr:
        ServeSpec(prefix_cache=True, paged=True).build_config()
    with pytest.raises(ValueError) as terr:
        build_config(prefix_cache=True)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("chunk", [0, 5])
def test_gqa_core_one_shot_and_chunked_match_jax(models, chunk):
    """_gqa_core's one-shot softmax and its chunked online-softmax path
    (Sk > attn_chunk) against JAX, with a causal mask and a softcap."""
    from repro.models.attention import _gqa_core as j_core
    from repro.models.common import causal_mask as j_mask
    from repro_torch.models.attention import _gqa_core as t_core
    from repro_torch.models.common import causal_mask as t_mask
    from repro.models.context import Ctx as JC
    cfg_j, _, cfg_t, _, _ = models
    cfg_j = cfg_j.replace(attn_chunk=chunk, attn_softcap=20.0)
    cfg_t = cfg_t.replace(attn_chunk=chunk, attn_softcap=20.0)
    rng = np.random.default_rng(chunk)
    q = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 17, 1, 16)).astype(np.float32)
    v = rng.normal(size=(2, 17, 1, 16)).astype(np.float32)
    qp = np.asarray([[3, 5, 8, 9, 12, 16], [0, 1, 2, 3, 4, 5]], np.int32)
    kp = np.broadcast_to(np.arange(17, dtype=np.int32), (2, 17))
    want = np.asarray(j_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             j_mask(jnp.asarray(qp), jnp.asarray(kp)),
                             cfg_j, JC()))
    got = t_core(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v),
                 t_mask(torch.from_numpy(qp), torch.from_numpy(kp.copy())),
                 cfg_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
