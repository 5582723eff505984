"""Layer stack (port of :mod:`repro.models.stack` for the serving and
training paths): attention and mamba blocks, each with a GLU MLP or, where
the config's ``moe_layer_mask`` says so, a mixture of experts, and with
cross attention in an encoder-decoder's decoder; mLSTM and sLSTM blocks
hold their own projections and no FFN.

A recurrent block's cache entry is its state, ``(batch, ...)`` rows on
both KV layouts; a step writes the new state into it in place, inactive
rows keeping theirs (JAX's ``_gate_state``)."""
from __future__ import annotations

import torch

from repro_torch.core.emt_linear import add_aux, new_aux
from repro_torch.models import common
from repro_torch.models.attention import (attention_specs, cross_attention,
                                          self_attention)
from repro_torch.models.config import ATTN_KINDS, ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.models.mamba import mamba, mamba_specs, mamba_state_specs
from repro_torch.models.mlp import mlp, mlp_specs
from repro_torch.models.moe import moe_ffn, moe_specs
from repro_torch.models.xlstm import (mlstm, mlstm_specs, mlstm_state_specs,
                                      slstm, slstm_specs, slstm_state_specs)

# recurrent kind -> (specs, mixer, state specs)
MIXERS = {"mamba": (mamba_specs, mamba, mamba_state_specs),
          "mlstm": (mlstm_specs, mlstm, mlstm_state_specs),
          "slstm": (slstm_specs, slstm, slstm_state_specs)}
# blocks that hold their own projections and no FFN
SELF_CONTAINED = ("mlstm", "slstm")


def block_specs(cfg: ModelConfig, kind: str, use_moe: bool,
                cross: bool = False, tag: str = "") -> dict:
    specs = {"norm1": common.rmsnorm_specs(cfg.d_model)}
    if kind in ATTN_KINDS:
        specs["attn"] = attention_specs(cfg, tag=f"{tag}/attn")
    elif kind in MIXERS:
        specs[kind] = MIXERS[kind][0](cfg, tag=f"{tag}/{kind}")
        if kind in SELF_CONTAINED:
            return specs
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if cross:
        specs["norm_x"] = common.rmsnorm_specs(cfg.d_model)
        specs["xattn"] = attention_specs(cfg, tag=f"{tag}/xattn")
    if cfg.d_ff > 0 or use_moe:
        specs["norm2"] = common.rmsnorm_specs(cfg.d_model)
        specs["ffn"] = (moe_specs(cfg, tag=f"{tag}/moe") if use_moe
                        else mlp_specs(cfg, tag=f"{tag}/mlp"))
    return specs


def block_state_specs(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      cross_len: int = 0) -> dict:
    """One block's contiguous cache entries, ``{name: (shape, dtype)}``: a
    recurrent block's state rows, or an attention block's ``k``/``v``
    (batch, length, KV, hd), plus ``ck``/``cv`` of `cross_len` positions in
    an enc-dec decoder.  The length is max_len, or ``min(window, max_len)``
    for a sliding-window layer, which keeps a ring buffer of its window."""
    if kind in MIXERS:
        return MIXERS[kind][2](cfg, batch)
    length = max_len
    if kind == "local" and cfg.sliding_window:
        length = min(max_len, cfg.sliding_window)
    kv = ((batch, length, cfg.num_kv_heads, cfg.head_dim), cfg.dtype)
    out = {"k": kv, "v": kv}
    if cross_len:
        out["ck"] = out["cv"] = ((batch, cross_len, cfg.num_kv_heads,
                                  cfg.head_dim), cfg.dtype)
    return out


def _gate_state(new, cache, active):
    """Write a recurrent block's new state into its cache rows in place,
    the rows of inactive slots frozen (`active` (B,) bool, None: every
    row); a missing cache or state (the exact sLSTM recurrence returns
    none) leaves the cache as it was."""
    if cache is None or new is None:
        return cache
    for name, t in cache.items():
        n = new[name].to(t.dtype)
        if active is not None:
            a = active.reshape(active.shape + (1,) * (n.dim() - 1))
            n = torch.where(a, n, t)
        t.copy_(n)
    return cache


def apply_block(params, x, cfg: ModelConfig, *, kind: str, use_moe: bool,
                tag: str, ctx: Ctx, positions, mask, positions3=None,
                cache=None, cache_index=None,
                active=None, page_tables=None, page_lens=None,
                chunk_lens=None, enc_out=None, enc_mask=None):
    """One residual block.  Paged steps give `page_tables`/`page_lens`
    (``lm.clamped_lens``): a local layer pages through the ring table when
    ``page_lens["ring"]`` says the window shrinks its cache (the flag, not
    equal lengths, decides: the engine's clamp can make the global view as
    long as the window), every other layer and the cross K/V through the
    global one.  A recurrent block (mamba, mLSTM, sLSTM) reads its state
    from `cache` and writes the new one there, rows of inactive slots
    kept.  Returns (y, aux, cache): the block's cache with new cross K/V
    merged in at prefill (None without a cache)."""
    h = common.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if kind in MIXERS:
        if chunk_lens is not None:
            # the state advances token by token; a padded mixed chunk would
            # march its padding lanes through it (the engine serves these
            # stacks on the legacy prefill)
            raise ValueError(f"chunked prefill requires an attention-only "
                             f"stack, got {kind!r}")
        y, aux, st = MIXERS[kind][1](params[kind], h, cfg, ctx=ctx,
                                     tag=f"{tag}/{kind}", state=cache)
        cache = _gate_state(st, cache, active)
        x = x + y
        if kind in SELF_CONTAINED:
            return x, aux, cache
        return _ffn(params, x, aux, cfg, use_moe=use_moe, tag=tag, ctx=ctx,
                    cache=cache)
    window = cfg.sliding_window if kind == "local" else 0
    m = mask
    if isinstance(mask, dict):
        m = mask["local"] if kind == "local" else mask["global"]
    pt = xpt = None
    pl = xpl = 0
    ring = False
    if page_tables is not None:
        ring = kind == "local" and page_lens["ring"]
        which = "local" if ring else "global"
        pt, pl = page_tables[which], page_lens[which]
        xpt, xpl = page_tables["global"], page_lens["global"]
    y, aux, cache = self_attention(
        params["attn"], h, cfg.replace(sliding_window=window),
        positions=positions, mask=m, ctx=ctx, tag=f"{tag}/attn", cache=cache,
        cache_index=cache_index, positions3=positions3, active=active,
        page_table=pt, page_len=pl, page_ring=ring, chunk_lens=chunk_lens)
    x = x + y
    if enc_out is not None or (cache is not None and "ck" in cache):
        h = common.rmsnorm(params["norm_x"], x, cfg.norm_eps)
        y, a, ckv = cross_attention(
            params["xattn"], h, cfg, enc_out=enc_out, enc_mask=enc_mask,
            ctx=ctx, tag=f"{tag}/xattn", cache=cache, page_table=xpt,
            page_len=xpl)
        aux = add_aux(aux, a)
        if ckv and cache is not None:
            cache = {**cache, **ckv}
        x = x + y
    return _ffn(params, x, aux, cfg, use_moe=use_moe, tag=tag, ctx=ctx,
                cache=cache)


def _ffn(params, x, aux, cfg: ModelConfig, *, use_moe: bool, tag: str,
         ctx: Ctx, cache):
    """The block's FFN residual (dense GLU or MoE), if it has one."""
    if "ffn" in params:
        h = common.rmsnorm(params["norm2"], x, cfg.norm_eps)
        if use_moe:
            y, a = moe_ffn(params["ffn"], h, cfg, ctx=ctx, tag=f"{tag}/moe")
        else:
            y, a = mlp(params["ffn"], h, cfg, ctx=ctx, tag=f"{tag}/mlp")
        aux = add_aux(aux, a)
        x = x + y
    return x, aux, cache


def stack_specs(cfg: ModelConfig, num_layers: int, kinds, moe_mask,
                cross: bool = False, tag: str = "") -> dict:
    return {f"layer_{i:03d}": block_specs(cfg, kinds[i], moe_mask[i], cross,
                                          tag=f"{tag}/layer_{i:03d}")
            for i in range(num_layers)}


def apply_stack(params, x, cfg: ModelConfig, kinds, moe_mask, *, ctx: Ctx,
                tag: str,
                positions, mask, positions3=None, caches=None,
                cache_index=None, active=None,
                page_tables=None, page_lens=None, chunk_lens=None,
                enc_out=None, enc_mask=None):
    """Apply the whole stack.  `caches` (layer name -> block cache) is None
    for the encoder; paged steps give `page_tables`/`page_lens`
    (:func:`apply_block` routes them).  Returns (x, aux, caches)."""
    aux = new_aux()
    lane_ok = None
    if chunk_lens is not None:
        # padding lanes (past a row's ntok, and idle rows) are zeroed between
        # blocks so they never raise an activation (DAC) quantization max
        C = x.shape[1]
        lane_ok = (torch.arange(C, device=x.device)[None, :]
                   < chunk_lens[:, None])
        if active is not None:
            lane_ok = lane_ok & active[:, None]
        lane_ok = lane_ok[:, :, None]
        x = torch.where(lane_ok, x, torch.zeros_like(x))
    new_caches = None if caches is None else {}
    for i, kind in enumerate(kinds):
        name = f"layer_{i:03d}"
        x, a, upd = apply_block(
            params[name], x, cfg, kind=kind, use_moe=moe_mask[i],
            tag=f"{tag}/{name}", ctx=ctx,
            positions=positions, mask=mask, positions3=positions3,
            cache=None if caches is None else caches[name],
            cache_index=cache_index, active=active, page_tables=page_tables,
            page_lens=page_lens, chunk_lens=chunk_lens, enc_out=enc_out,
            enc_mask=enc_mask)
        aux = add_aux(aux, a)
        if new_caches is not None:
            new_caches[name] = upd
        if lane_ok is not None:
            x = torch.where(lane_ok, x, torch.zeros_like(x))
    return x, aux, new_caches
