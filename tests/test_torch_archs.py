"""Port parity of the five architectures the port gained last: gemma2-9b
(alternating local and global layers, softcaps 50 and 30), llama3-405b and
deepseek-67b (dense GQA), qwen2-vl-72b (M-RoPE, the "embeds" input kind)
and llama4-scout-17b-a16e (16 experts top-1, "embeds"), at smoke widths
(analog, hash backend, per-row DAC scale, frozen noise, float32), JAX's
weights carried across by the numpy bridge.  JAX's prefill, decode step
and training forward of an arch run in one jitted call (one compile,
shared by the tests through a module fixture), their DAC levels recorded
by ordered host callbacks and replayed in the port's.

* ``common.apply_mrope`` against JAX's on three different position
  streams (atol 1e-6), and equal to ``apply_rope`` on equal streams.
* The configs: ``get_config`` and ``ServeSpec.build_config`` of the
  published and smoke configs equal JAX's on every field the port keeps.
* Model steps: a legacy prefill (batch 2, one row left-padded; random
  embeddings for the "embeds" stacks) into a contiguous cache and a decode
  step with an idle row: logits within 1e-4, caches within 1e-5, energy
  within rtol 1e-5, ``kv_reads`` within rtol 1e-6; ``train_loss`` (tokens,
  or embeddings, of 2 x 16) within rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import jax_levels, port_levels, shared_weights
from repro.configs import get_config as jget_config
from repro.core import emt_linear as jel
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models.context import Ctx as JCtx
from repro.serve.spec import ServeSpec as JSpec
from repro_torch.configs import get_config as tget_config
from repro_torch.core import emt_linear as tel
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.context import Ctx as TCtx
from repro_torch.serve.spec import ServeSpec as TSpec

NEW_ARCHS = ("gemma2-9b", "llama3-405b", "deepseek-67b", "qwen2-vl-72b",
             "llama4-scout-17b-a16e")
EMBEDS = ("qwen2-vl-72b", "llama4-scout-17b-a16e")
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
# the fields the port's ModelConfig keeps beside JAX's (JAX's own ones are
# its kernel switch paged_attn_impl and remat)
FIELDS = tuple(f.name for f in dataclasses.fields(TConfig)
               if f.name not in ("dtype", "emt", "logit_dtype"))


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax_on_distinct_streams(sections, hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    p3 = np.stack([rng.integers(0, 4096, (2, 7)) for _ in range(3)]) \
        .astype(np.int32)
    assert not (p3[0] == p3[1]).all() and not (p3[1] == p3[2]).all()
    want = np.asarray(jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(p3),
                                          sections, 1.0e6))
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3),
                              sections, 1.0e6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_mrope_equals_rope_for_text():
    """Three equal streams reduce M-RoPE to RoPE (the mirror of
    tests/test_models.py::test_mrope_equals_rope_for_text)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 4, 16)).astype(np.float32))
    pos = torch.arange(8)[None].expand(2, 8)
    y1 = tcommon.apply_rope(x, pos)
    y2 = tcommon.apply_mrope(x, pos[None].expand(3, 2, 8), (2, 3, 3))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-6)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_jax(arch):
    """The published and the smoke config, and ServeSpec's smoke build,
    field for field; llama4-scout's experts on every layer."""
    for smoke in (False, True):
        cj = jget_config(arch, smoke=smoke)
        ct = tget_config(arch, smoke=smoke)
        for f in FIELDS:
            assert getattr(ct, f) == getattr(cj, f), (smoke, f)
        assert ct.blocks() == cj.blocks()
        assert ct.moe_layer_mask() == cj.moe_layer_mask()
        assert ct.layer_paths() == cj.layer_paths()
    cj = JSpec(arch=arch).build_config()
    ct = TSpec(arch=arch).build_config()
    for f in FIELDS:
        assert getattr(ct, f) == getattr(cj, f), f


def _spec(mod, arch):
    return mod(arch=arch, mode="analog", a_per_row=True, frozen_noise=True,
               smoke=True)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def models(request):
    arch = request.param
    cfg_j = _spec(JSpec, arch).build_config()
    cfg_t = _spec(TSpec, arch).build_config()
    params_j, params_t = shared_weights(cfg_t)
    return arch, cfg_j, params_j, cfg_t, params_t


def _np_cache(c):
    return {name: {k: np.asarray(v).copy() for k, v in blk.items()}
            for name, blk in c.items()}


B, L, S = 2, 24, 16


def _inputs(arch, cfg):
    """The prefill batch (row 1 left-padded by 5; random embeddings for the
    embeds stacks), the decode step's positions and active rows, and the
    training batch of 2 x 16 (embeddings for the embeds stacks)."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    toks[1, :5] = 0
    pre = {"tokens": toks}
    train = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if arch in EMBEDS:
        pre["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
        train["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return (pre, np.asarray([S, S], np.int32), np.asarray([True, False]),
            train)


@pytest.fixture(scope="module")
def jax_run(models):
    """JAX's prefill, decode step and training forward of one arch in one
    jitted call (one compile), its DAC levels recorded in program order:
    a step quantizes the input of each of the config's placed projections
    but the expert stacks once, so the levels split in three equal
    parts."""
    arch, cfg_j, params_j, cfg_t, _ = models
    pre, pos, act, train = _inputs(arch, cfg_t)

    def steps(p, pre, pos, act, train):
        cache, lg0, a0 = jlm.prefill(p, pre, cfg_j, JCtx(seed=jnp.uint32(7)),
                                     jlm.init_cache(cfg_j, B, L))
        out = [(lg0, a0, cache)]
        tok = jnp.argmax(lg0, -1).astype(jnp.int32)
        lg1, cache, a1 = jlm.decode_step(p, cache, tok, pos, cfg_j,
                                         JCtx(seed=jnp.uint32(7)),
                                         active=act)
        out.append((lg1, a1, cache))
        # without remat: jax.checkpoint turns the aux's layer count into a
        # tracer, which the rho_mean metric cannot take; no value changes
        metrics = jlm.train_loss(p, train, cfg_j.replace(remat=False),
                                 JCtx(seed=jnp.uint32(3)), lam=1e-6)[1]
        return out, metrics

    lv = []
    with jax_levels(jel, lv):
        out, metrics = jax.jit(steps)(
            params_j, {k: jnp.asarray(v) for k, v in pre.items()},
            jnp.asarray(pos), jnp.asarray(act),
            {k: jnp.asarray(v) for k, v in train.items()})
    out = [(np.asarray(lg), a, _np_cache(c)) for lg, a, c in out]
    n = sum(1 for path, _, mode in cfg_t.placement_plan()
            if mode != "fp32" and not path.endswith("/moe/experts"))
    assert len(lv) == 3 * n, (len(lv), n)
    return out, metrics, lv[:2 * n], lv[2 * n:]


def test_prefill_and_decode_steps_match_jax(models, jax_run):
    """A legacy prefill of 16 positions (row 1 left-padded by 5; gemma2's
    window-8 ring caches wrap) into a contiguous cache of 24, then a decode
    step with row 1 idle, on JAX's levels: logits, caches, energy and
    kv_reads against JAX's; the idle row's cache untouched."""
    arch, _, _, cfg_t, params_t = models
    out_j, _, lv, _ = jax_run
    pre, pos, act, _ = _inputs(arch, cfg_t)
    batch_t = {k: torch.from_numpy(v).long() if v.dtype == np.int32
               else torch.from_numpy(v) for k, v in pre.items()}
    out_t, replay = [], list(lv)
    with port_levels(tel, [], replay=replay):
        c = tlm.init_cache(cfg_t, B, L, device="cpu")
        c, lg, a = tlm.prefill(params_t, batch_t, cfg_t, TCtx(seed=7), c)
        out_t.append((lg, a, _np_cache(c)))
        before = _np_cache(c)
        lg, c, a = tlm.decode_step(
            params_t, c, lg.argmax(-1), torch.from_numpy(pos).long(), cfg_t,
            TCtx(seed=7), active=torch.from_numpy(act))
        out_t.append((lg, a, _np_cache(c)))
    assert not replay                           # every level consumed
    for name, blk in c.items():                 # row 1 idle in the decode
        for key, v in blk.items():
            np.testing.assert_array_equal(v[1].numpy(), before[name][key][1])
    for (lj, aj, cj), (lt, at, ct) in zip(out_j, out_t):
        np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=LOGIT_TOL)
        np.testing.assert_array_equal(lt.argmax(-1).numpy(), lj.argmax(-1))
        np.testing.assert_allclose(float(at["energy_pj"]),
                                   float(aj["energy_pj"]), rtol=1e-5)
        np.testing.assert_allclose(float(at["kv_reads"]),
                                   float(aj["kv_reads"]), rtol=1e-6)
        for name, blk in ct.items():
            for key, v in blk.items():
                np.testing.assert_allclose(v, cj[name][key], rtol=0,
                                           atol=CACHE_TOL,
                                           err_msg=f"{name}/{key}")


def test_train_loss_matches_jax(models, jax_run):
    """The training forward on 2 x 16 tokens (the "embeds" stacks on
    random embeddings of 2 x 16 x d_model): loss, cross-entropy, energy,
    the reg term and the MoE aux loss against JAX's on its levels."""
    arch, _, _, cfg_t, params_t = models
    _, mj, _, lv = jax_run
    *_, train = _inputs(arch, cfg_t)
    replay = list(lv)
    with port_levels(tel, [], replay=replay):
        _, mt = tlm.train_loss(params_t, {
            k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in train.items()}, cfg_t,
            TCtx(seed=3), lam=1e-6)
    assert not replay
    for key in ("loss", "ce", "energy_uj", "reg", "aux_loss"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
