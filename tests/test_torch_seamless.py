"""Port parity for the encoder-decoder slice: seamless-m4t-medium (smoke
size: 2 encoder + 2 decoder layers, d_model 64, 4 heads MHA, head_dim 16,
f32, analog, per-tensor DAC scale), JAX weights carried across by the numpy
bridge; the activations; and the read-only paged-attention kernel's (K4)
plain version against the JAX reference and interpret-mode Pallas.

Tolerances: activations 1e-6 (float32 tanh forms); K4 outputs 1e-6 absolute
(unit-normal inputs, one-shot vs online softmax, float32 sum order), fully
masked rows exactly zero; prefill logits and contiguous k/v/ck/cv 1e-5
(4 layers of float32 projections in another sum order); decode logits 1e-4
with greedy tokens identical over 8 steps (as the decoder-only parity
tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _tree_to_arrays
from repro.configs import get_config as j_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro.nn.param import init_params
from repro.serve.engine import make_paged_insert
from repro.serve.kv_pool import PagedKV as JKV
from repro.serve.spec import ServeSpec
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as k4
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models.context import Ctx as TCtx
from repro_torch.serve.engine import paged_insert
from repro_torch.serve.kv_pool import PagedKV as TKV
from repro_torch.serve.spec import build_config
from repro_torch.utils.pytrees import flatten_with_paths

ARCH = "seamless-m4t-medium"
SEED = 3


def _t(a):
    return torch.from_numpy(np.array(a))


# -- activations -------------------------------------------------------------
@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "gelu_tanh"])
def test_activation_matches_jax(name):
    """jax.nn.gelu defaults to the tanh form; the port's "gelu" is that
    form, not torch's exact erf default (which differs in the fourth
    decimal)."""
    x = np.linspace(-4.0, 4.0, 4001, dtype=np.float32)
    want = np.asarray(jcommon.activation(name)(jnp.asarray(x)))
    got = tcommon.activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- K4: read-only paged attention -------------------------------------------
def _k4_case(rng, B, KV, G, hd, bs, T, L):
    NB = B * T + 1
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    kp = rng.normal(size=(NB + 1, bs, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(NB + 1, bs, KV, hd)).astype(np.float32)
    kp[NB] = vp[NB] = 0.0
    table = rng.permutation(NB)[:B * T].reshape(B, T).astype(np.int32)
    table[:, -1] = NB                        # unallocated tail -> zero block
    lens = rng.integers(1, L + 1, size=B)
    mask = np.where(np.arange(L)[None, :] < lens[:, None], 0.0,
                    NEG_INF).astype(np.float32)
    return q, kp, vp, table, mask


def _k4_all(q, kp, vp, table, mask, softcap=0.0):
    """(port ops, JAX ref rung, JAX interpret-mode Pallas) outputs."""
    args = [jnp.asarray(a) for a in (q, kp, vp, table, mask)]
    kpt, vpt = _t(kp), _t(vp)
    got = tops.paged_attention(_t(q), kpt, vpt, _t(table), _t(mask),
                               softcap=softcap).numpy()
    assert np.array_equal(kpt.numpy(), kp) and np.array_equal(vpt.numpy(), vp)
    return got, *(np.asarray(jops.paged_attention(*args, softcap=softcap,
                                                  impl=impl))
                  for impl in ("ref", "interpret"))


@pytest.mark.parametrize("bs,KV,G", [(2, 1, 4), (4, 2, 2), (8, 4, 1)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_k4_plain_matches_ref_and_interpret(bs, KV, G, softcap):
    """Mirrors tests/test_paged_attention.py::
    test_kernel_matches_ref_and_oracle; the pools are read, never written."""
    rng = np.random.default_rng(bs * 100 + KV * 10 + G)
    T = 4
    case = _k4_case(rng, B=3, KV=KV, G=G, hd=16, bs=bs, T=T, L=T * bs)
    got, ref, interp = _k4_all(*case, softcap=softcap)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, interp, rtol=0, atol=1e-6)
    # the plain version is the ref's one-shot masked softmax, term for term
    args = [jnp.asarray(a) for a in case]
    np.testing.assert_allclose(
        got, np.asarray(jref.paged_attention_ref(*args, softcap=softcap)),
        rtol=0, atol=1e-6)


def test_k4_partial_last_block():
    """Logical length not a block multiple: the wrapper masks the rounding
    tail with NEG_INF, as JAX's does."""
    rng = np.random.default_rng(7)
    q, kp, vp, table, mask = _k4_case(rng, B=2, KV=2, G=2, hd=16, bs=4, T=2,
                                      L=8)
    got, ref, interp = _k4_all(q, kp, vp, table, mask[:, :6])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, interp, rtol=0, atol=1e-6)


def test_k4_fully_masked_row_is_zero():
    """A row with no visible position (an idle slot's encoder length 0)
    gives exact zeros, not NaN, in the port and in both JAX rungs."""
    rng = np.random.default_rng(3)
    q, kp, vp, table, mask = _k4_case(rng, B=2, KV=1, G=2, hd=8, bs=4, T=2,
                                      L=8)
    mask[1] = NEG_INF
    for y in _k4_all(q, kp, vp, table, mask):
        assert np.isfinite(y).all()
        np.testing.assert_array_equal(y[1], 0.0)


def test_k4_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    args = [_t(a) for a in _k4_case(rng, B=3, KV=2, G=1, hd=8, bs=4, T=3,
                                    L=12)]
    before = k4.paged_attention.launches
    out = k4.paged_attention(*args)
    np.testing.assert_array_equal(out.numpy(), k4.plain_attend(*args).numpy())
    assert k4.paged_attention.launches == before          # no kernel on CPU


# -- configuration and the weight bridge -------------------------------------
@pytest.fixture(scope="module")
def models():
    cfg_j = ServeSpec(arch=ARCH, mode="analog", smoke=True).build_config()
    params_j = init_params(jlm.specs(cfg_j), jax.random.PRNGKey(0))
    arrays = _tree_to_arrays(params_j)
    cfg_t = build_config(ARCH, smoke=True)
    params_t = tlm.load_jax_arrays(arrays, cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t, arrays


def test_config_mirrors_jax(models):
    cfg_j, _, cfg_t, _, _ = models
    for f in ("num_layers", "encoder_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "head_dim", "rope_theta",
              "sliding_window", "qk_norm", "tie_embeddings", "embed_scale",
              "norm_eps", "act", "layer_pattern", "is_encdec",
              "fused_paged_attn"):
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    full_j, full_t = j_get_config(ARCH), t_get_config(ARCH)
    for f in ("num_layers", "encoder_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "vocab_size", "act"):
        assert getattr(full_t, f) == getattr(full_j, f), f
    # placement paths cover enc/.../attn and dec/.../xattn, resolved as JAX
    # resolves them (the mixed placement's "*/xattn/*" rule included)
    assert cfg_t.layer_paths() == cfg_j.layer_paths()
    mixed_j = j_get_config(ARCH, smoke=True, placement="mixed")
    mixed_t = t_get_config(ARCH, smoke=True, placement="mixed")
    assert mixed_t.placement_plan() == mixed_j.placement_plan()
    assert any("/xattn/" in p for p, _, _ in mixed_t.placement_plan())


def test_build_config_resolves_full_width_seamless():
    """The published widths: 12 + 12 layers, d_model 1024, 16 heads of 64,
    d_ff 4096, vocab 256206, untied lm_head; ~0.98 G parameters."""
    cfg = build_config(ARCH, smoke=False, a_per_row=True)
    assert (cfg.encoder_layers, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (12, 12, 1024, 16, 16, 64, 4096, 256206)
    assert cfg.dtype == torch.float32 and not cfg.tie_embeddings
    assert cfg.emt.quant.a_per_row
    n = sum(int(np.prod(s.shape)) for _, s in flatten_with_paths(
        tlm.specs(cfg)))
    assert 0.97e9 < n < 0.99e9, n


def test_bridge_loads_encdec_tree_and_rejects_bad_trees(models):
    _, _, cfg_t, params_t, arrays = models
    for path in ("encoder/layer_001/attn/wq/w", "enc_norm/scale",
                 "decoder/layer_000/xattn/wk/w", "decoder/layer_001/norm_x/"
                 "scale", "lm_head/w"):
        assert path in arrays, path
    assert set(params_t) == {"embed", "decoder", "final_norm", "lm_head",
                             "encoder", "enc_norm"}
    missing = dict(arrays)
    missing.pop("decoder/layer_001/xattn/wk/w")
    with pytest.raises(KeyError, match="missing"):
        tlm.load_jax_arrays(missing, cfg_t, device="cpu")
    extra = dict(arrays, **{"encoder/layer_002/attn/wq/w": np.zeros(1)})
    with pytest.raises(KeyError, match="encoder/layer_002"):
        tlm.load_jax_arrays(extra, cfg_t, device="cpu")


# -- the model steps ---------------------------------------------------------
def _prefill_both(models, plen, S, max_len, rng):
    """Batch-1 legacy prefill of a left-padded prompt with random encoder
    frame embeddings in both frameworks."""
    cfg_j, params_j, cfg_t, params_t, _ = models
    toks = np.zeros((1, S), np.int32)
    toks[0, S - plen:] = rng.integers(0, cfg_t.vocab_size, plen)
    enc = rng.normal(size=(1, S, cfg_t.d_model)).astype(np.float32)
    batch = {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)}
    cj, lj, aj = jlm.prefill(params_j, batch, cfg_j,
                             JCtx(seed=jnp.uint32(SEED)),
                             jlm.init_cache(cfg_j, 1, max_len))
    ct, lt, at = tlm.prefill(
        params_t, {"tokens": _t(toks).long(), "enc_embeds": _t(enc)}, cfg_t,
        TCtx(seed=SEED), tlm.init_cache(cfg_t, 1, max_len, device="cpu"))
    return (cj, lj, aj), (ct, lt, at)


def test_prefill_logits_and_caches_match(models):
    (cj, lj, aj), (ct, lt, at) = _prefill_both(models, 5, 8, 16,
                                               np.random.default_rng(0))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)
    for name in cj:
        assert tuple(ct[name]["k"].shape) == (1, 16, 4, 16)
        assert tuple(ct[name]["ck"].shape) == (1, 8, 4, 16)   # bucket, not 16
        for key in ("k", "v", "ck", "cv"):
            np.testing.assert_allclose(ct[name][key].numpy(),
                                       np.asarray(cj[name][key]), rtol=0,
                                       atol=1e-5, err_msg=f"{name}/{key}")
        assert float(ct[name]["ck"].abs().max()) > 0          # not all zero
    for key in ("energy_pj", "reg"):
        np.testing.assert_allclose(float(at[key]), float(aj[key]), rtol=1e-5)
    assert float(at["kv_reads"]) == float(aj["kv_reads"]) == 0.0


@pytest.mark.parametrize("fused", [True, False])
def test_paged_decode_with_enc_lens_matches(models, fused):
    """Two rows prefilled (buckets 8 and 4) and inserted into the pools, one
    idle row (encoder length 0); 8 greedy decode steps through the paged
    cross attention (K4's plain version, or gather + _gqa_core)."""
    cfg_j, params_j, cfg_t, params_t, _ = models
    cfg_j = cfg_j.replace(fused_paged_attn=fused)
    cfg_t = cfg_t.replace(fused_paged_attn=fused)
    B, max_len, bs, nb = 3, 16, 4, 12
    rng = np.random.default_rng(1)
    jkv, tkv = JKV(B, max_len, bs, nb), TKV(B, max_len, bs, nb)
    pj = jlm.init_paged_cache(cfg_j, B, max_len, bs, nb)
    pt = tlm.init_paged_cache(cfg_t, B, max_len, bs, nb, device="cpu")
    insert = make_paged_insert(cfg_j, bs, jlm.paged_lens(cfg_j, max_len))
    enc_lens, pos, first = np.zeros(B, np.int32), np.zeros(B, np.int32), \
        np.zeros(B, np.int32)
    for slot, (plen, S) in enumerate([(6, 8), (3, 4)]):
        (cj, lj, _), (ct, lt, _) = _prefill_both(models, plen, S, max_len,
                                                 rng)
        assert jkv.admit(slot, S, 8) and tkv.admit(slot, S, 8)
        row, _ = tkv.scatter_rows(slot)
        np.testing.assert_array_equal(row, jkv.scatter_rows(slot)[0])
        pj = insert(pj, cj, jnp.asarray(row), jnp.asarray(row),
                    jnp.int32(slot))
        paged_insert(pt, ct, row)
        enc_lens[slot], pos[slot] = S, S
        first[slot] = int(np.argmax(np.asarray(lj)[0]))
    for name in pj:
        for key in pj[name]:
            np.testing.assert_allclose(pt[name][key].numpy(),
                                       np.asarray(pj[name][key]), rtol=0,
                                       atol=1e-5)
    act = np.asarray([True, True, False])
    tok = first
    for step in range(8):
        for s in (0, 1):
            jkv.ensure(s, int(pos[s]))
            tkv.ensure(s, int(pos[s]))
        tg, _ = jkv.gather_tables()
        np.testing.assert_array_equal(tkv.gather_tables()[0], tg)
        view = 16
        lens_j = jlm.clamped_lens(jlm.paged_lens(cfg_j, max_len), view)
        lens_t = tlm.clamped_lens(tlm.paged_lens(cfg_t, max_len), view)
        lj, pj, aj = jlm.decode_step(
            params_j, pj, jnp.asarray(tok), jnp.asarray(pos), cfg_j,
            JCtx(seed=jnp.uint32(SEED + step)), active=jnp.asarray(act),
            page_tables={"global": jnp.asarray(tg), "local": jnp.asarray(tg)},
            page_lens=lens_j, enc_lens=jnp.asarray(enc_lens))
        lt, pt, at = tlm.decode_step(
            params_t, pt, _t(tok).long(), _t(pos).long(), cfg_t,
            TCtx(seed=SEED + step), active=_t(act),
            page_tables={"global": _t(tg)}, page_lens=lens_t,
            enc_lens=_t(enc_lens).long())
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
        pos = pos + act
