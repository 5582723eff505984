"""Grouped-query attention with RoPE, qk-norm, a paged KV cache and
encoder-decoder cross attention, every projection an EMT crossbar matmul
(port of :mod:`repro.models.attention`, global layers).

Paged decode runs ONE fused kernel launch per layer (K/V write + attend,
``kernels.ops.paged_attention_decode``); chunked prefill writes the chunk's
K/V and attends through the flash-style prefill kernel
(``kernels.ops.paged_prefill``); the cross attention's decode reads the
paged cross K/V through the read-only kernel (``kernels.ops.
paged_attention``).  ``cfg.fused_paged_attn=False`` takes the plain path
instead: scatter, gather the logical view, ``_gqa_core``.  The encoder and
the legacy bucketed prefill attend within the sequence (no paging); the
prefill fills a contiguous batch-1 cache.  Caches are updated in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.emt_linear import add_aux, dense_specs, emt_dense, new_aux
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx


def attention_specs(cfg: ModelConfig, tag: str = "") -> dict:
    """Self or cross attention (the same projections; `tag` names the
    canonical path, ``.../attn`` or ``.../xattn``)."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": dense_specs(D, H * hd, cfg.emt_at(f"{tag}/wq"), dtype=cfg.dtype),
        "wk": dense_specs(D, KV * hd, cfg.emt_at(f"{tag}/wk"), dtype=cfg.dtype),
        "wv": dense_specs(D, KV * hd, cfg.emt_at(f"{tag}/wv"), dtype=cfg.dtype),
        "wo": dense_specs(H * hd, D, cfg.emt_at(f"{tag}/wo"), dtype=cfg.dtype),
    }
    if cfg.qk_norm:
        specs["qnorm"] = common.rmsnorm_specs(hd)
        specs["knorm"] = common.rmsnorm_specs(hd)
    return specs


def _project_qkv(params, x, cfg: ModelConfig, ctx: Ctx, tag: str):
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    aux = new_aux()
    out = []
    for name in ("wq", "wk", "wv"):
        y, a = emt_dense(params[name], x, cfg.emt_at(f"{tag}/{name}"),
                         tag=f"{tag}/{name}", seed=ctx.seed)
        aux = add_aux(aux, a)
        out.append(y)
    q = out[0].reshape(*x.shape[:-1], H, hd)
    k = out[1].reshape(*x.shape[:-1], KV, hd)
    v = out[2].reshape(*x.shape[:-1], KV, hd)
    if cfg.qk_norm:
        q = common.rmsnorm(params["qnorm"], q, cfg.norm_eps)
        k = common.rmsnorm(params["knorm"], k, cfg.norm_eps)
    return q, k, v, aux


def _gqa_core(q, k, v, mask, cfg: ModelConfig):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd), mask (B, 1, Sq, Sk) additive
    or None (attend everywhere).  Sequences longer than ``cfg.attn_chunk``
    run the chunked online-softmax path.  Returns (B, Sq, H * hd) in v's
    dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    Sk = k.shape[1]
    qg = q.reshape(B, Sq, KV, G, hd)
    chunk = cfg.attn_chunk
    scale = float(np.float32(np.sqrt(hd)))

    def scores_of(kc):
        return torch.einsum("bqkgh,bskh->bkgqs", qg, kc) / scale

    if Sq == 1 or not chunk or Sk <= chunk:
        s = common.softcap(scores_of(k), cfg.attn_softcap)
        if mask is not None:
            s = s + mask.reshape(B, 1, 1, Sq, -1)
        probs = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
        return out.reshape(B, Sq, H * hd).to(v.dtype)

    m = torch.full((B, KV, G, Sq), common.NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Sk, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = common.softcap(scores_of(kc), cfg.attn_softcap)
        if mask is not None:
            s = s + mask[:, :, :, c0:c0 + chunk].reshape(B, 1, 1, Sq, -1)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.where(s > common.NEG_INF / 2,
                        torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(vc.dtype), vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H * hd).to(v.dtype)


def _visible_kv_elems(mask, kv_heads: int, head_dim: int):
    """K/V cache elements a decode step reads: mask-visible positions x
    kv heads x head_dim x 2 (K and V)."""
    vis = torch.sum((mask > common.NEG_INF / 2).to(torch.float32))
    return vis * float(kv_heads * head_dim * 2)


def _visible_chunk_kv_elems(mask, valid, kv_heads: int, head_dim: int):
    """Chunk-step K/V read billing: mask-visible positions of real lanes
    only (padding lanes duplicate the row's last real lane)."""
    vis = (mask > common.NEG_INF / 2).to(torch.float32)
    vis = vis * valid[:, None, :, None].to(torch.float32)
    return torch.sum(vis) * float(kv_heads * head_dim * 2)


def paged_gather(pool, table, length: int):
    """(B, length, ...) logical view out of a block pool (zero block last)."""
    bs = pool.shape[1]
    j = torch.arange(length, device=pool.device)
    return pool[table[:, j // bs].long(), (j % bs)[None, :]]


def _paged_write(pool, table, wpos, val, active):
    """Row b writes pool[table[b, wpos[b] // bs], wpos[b] % bs] in place;
    inactive rows write nothing."""
    bs = pool.shape[1]
    blk = torch.gather(table.long(), 1, (wpos.long() // bs)[:, None])[:, 0]
    rows = torch.arange(wpos.shape[0], device=pool.device)
    if active is not None:
        rows = rows[active]
    pool.index_put_((blk[rows], wpos.long()[rows] % bs),
                    val[rows].to(pool.dtype))
    return pool


def _chunk_write(cache_kv, wpos, val, write_ok, page_table):
    """Scatter a (B, C) chunk of K or V rows through the block table in
    place; lanes with write_ok False are dropped."""
    bs = cache_kv.shape[1]
    b, c = torch.nonzero(write_ok, as_tuple=True)
    pos = wpos.long()[b, c]
    cache_kv.index_put_((page_table.long()[b, pos // bs], pos % bs),
                        val[b, c].to(cache_kv.dtype))
    return cache_kv


def _chunk_attend(q, k, v, cache, mask, *, start, ntok, positions, active,
                  page_table, page_len: int, cfg: ModelConfig):
    """Chunked mixed prefill+decode cache update + attention for one global
    layer: row b's first ntok[b] lanes are real tokens at positions
    start[b] ..; the rest are padding (writes dropped).  Write-then-attend.
    Returns (y, cache, kv_read_elems)."""
    B, C = positions.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    j = torch.arange(C, device=positions.device)[None, :]
    valid = j < ntok[:, None]
    qpos = start[:, None] + torch.minimum(j, ntok[:, None] - 1)
    write_ok = valid if active is None else valid & active[:, None]
    _chunk_write(cache["k"], positions, k, write_ok, page_table)
    _chunk_write(cache["v"], positions, v, write_ok, page_table)
    kv_reads = _visible_chunk_kv_elems(mask, valid, KV, hd)
    if cfg.fused_paged_attn:
        y = kops.paged_prefill(q, cache["k"], cache["v"], page_table, qpos,
                               softcap=float(cfg.attn_softcap or 0.0))
        return y.to(cache["k"].dtype), cache, kv_reads
    k_att = paged_gather(cache["k"], page_table, page_len)
    v_att = paged_gather(cache["v"], page_table, page_len)
    return _gqa_core(q, k_att, v_att, mask, cfg), cache, kv_reads


def self_attention(params, x, cfg: ModelConfig, *, positions, mask,
                   ctx: Ctx, tag: str, cache=None, cache_index=None,
                   active=None, page_table=None, page_len: int = 0,
                   chunk_lens=None):
    """Self-attention.

    No cache (the encoder): x (B, S, D) attends within itself under `mask`.
    Prefill (``cache_index`` None): x (B, S, D) fills positions [0, S) of the
    contiguous cache ``{"k", "v"}`` (B, max_len, KV, hd) and attends within
    the prompt.  Paged decode (``chunk_lens`` None): x (B, 1, D),
    ``cache_index`` (B,) write positions.  Paged chunk step: x (B, C, D)
    with ``chunk_lens`` (B,) real lanes per row, ``cache_index`` the per-row
    start, ``positions`` (B, C).  Returns (y, aux, cache) with the cache's
    tensors updated in place (None without a cache)."""
    if cache is not None and cache_index is not None and page_table is None:
        raise NotImplementedError(
            "decode against the contiguous KV cache is ported with a later "
            "slice (ROADMAP Queue 1, serving core)")
    q, k, v, aux = _project_qkv(params, x, cfg, ctx, tag)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    B = x.shape[0]
    idx = cache_index
    if cache is None or idx is None:
        if cache is not None:
            S = k.shape[1]
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
        y = _gqa_core(q, k, v, mask, cfg)
    elif chunk_lens is not None:
        y, cache, reads = _chunk_attend(
            q, k, v, cache, mask, start=idx, ntok=chunk_lens,
            positions=positions, active=active, page_table=page_table,
            page_len=page_len, cfg=cfg)
        aux["kv_reads"] = aux["kv_reads"] + reads
    else:
        L = page_len
        mask_rows = mask.reshape(B, L)
        aux["kv_reads"] = aux["kv_reads"] + _visible_kv_elems(mask_rows, KV,
                                                              hd)
        H = cfg.num_heads
        if cfg.fused_paged_attn:
            out, _, _ = kops.paged_attention_decode(
                q[:, 0].reshape(B, KV, H // KV, hd), cache["k"], cache["v"],
                page_table, mask_rows, k[:, 0], v[:, 0], idx, active,
                softcap=float(cfg.attn_softcap or 0.0))
            y = out.reshape(B, 1, H * hd).to(cache["k"].dtype)
        else:
            _paged_write(cache["k"], page_table, idx, k[:, 0], active)
            _paged_write(cache["v"], page_table, idx, v[:, 0], active)
            y = _gqa_core(q, paged_gather(cache["k"], page_table, L),
                          paged_gather(cache["v"], page_table, L),
                          mask_rows[:, None, None, :], cfg)
    o, a = emt_dense(params["wo"], y, cfg.emt_at(f"{tag}/wo"),
                     tag=f"{tag}/wo", seed=ctx.seed)
    return o, add_aux(aux, a), cache


def cross_attention(params, x, cfg: ModelConfig, *, enc_out=None,
                    enc_mask=None, ctx: Ctx, tag: str, cache=None,
                    page_table=None, page_len: int = 0):
    """Encoder-decoder cross attention.

    Prefill (`enc_out` given): K/V projected from `enc_out` (B, S_enc, D);
    returns the new ``{"ck", "cv"}`` of the encoder's length.  Paged decode
    (`enc_out` None, `cache` holding the ``ck``/``cv`` pools): the cross K/V
    written once at admission are read through the block table (read-only)
    under `enc_mask` (B, 1, 1, page_len), the rows of each slot's real
    encoder positions; ``kv_reads`` books the visible positions.  Returns
    (y, aux, new cross K/V or None)."""
    aux = new_aux()
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, a = emt_dense(params["wq"], x, cfg.emt_at(f"{tag}/wq"),
                     tag=f"{tag}/wq", seed=ctx.seed)
    aux = add_aux(aux, a)
    q = q.reshape(*x.shape[:-1], H, hd)
    new_cache = None
    if enc_out is None:
        if page_table is None:
            raise NotImplementedError(
                "cross attention against the contiguous cache is ported with "
                "a later slice (ROADMAP Queue 1, serving core)")
        B, L = x.shape[0], page_len
        mask_rows = (enc_mask.reshape(B, L) if enc_mask is not None
                     else torch.zeros((B, L), dtype=torch.float32,
                                      device=x.device))
        aux["kv_reads"] = aux["kv_reads"] + _visible_kv_elems(mask_rows, KV,
                                                              hd)
        if cfg.fused_paged_attn:
            out = kops.paged_attention(
                q[:, 0].reshape(B, KV, H // KV, hd), cache["ck"], cache["cv"],
                page_table, mask_rows, softcap=float(cfg.attn_softcap or 0.0))
            y = out.reshape(B, 1, H * hd).to(cache["ck"].dtype)
        else:
            y = _gqa_core(q, paged_gather(cache["ck"], page_table, L),
                          paged_gather(cache["cv"], page_table, L), enc_mask,
                          cfg)
    else:
        out = []
        for name in ("wk", "wv"):
            t, a = emt_dense(params[name], enc_out,
                             cfg.emt_at(f"{tag}/{name}"), tag=f"{tag}/{name}",
                             seed=ctx.seed)
            aux = add_aux(aux, a)
            out.append(t.reshape(*enc_out.shape[:-1], KV, hd))
        new_cache = {"ck": out[0], "cv": out[1]}
        y = _gqa_core(q, out[0], out[1], enc_mask, cfg)
    o, a = emt_dense(params["wo"], y, cfg.emt_at(f"{tag}/wo"),
                     tag=f"{tag}/wo", seed=ctx.seed)
    return o, add_aux(aux, a), new_cache
