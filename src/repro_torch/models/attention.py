"""Grouped-query attention with RoPE, qk-norm, sliding windows, paged and
contiguous KV caches and encoder-decoder cross attention, every projection
an EMT crossbar matmul (port of :mod:`repro.models.attention`).

Paged decode runs ONE fused kernel launch per layer (K/V write + attend,
``kernels.ops.paged_attention_decode``), on a global layer's table or a
ring layer's window-sized one (write at ``pos mod window``, ring position
mask); chunked prefill writes a global layer's chunk K/V and attends
through the flash-style prefill kernel (``kernels.ops.paged_prefill``); the
cross attention's decode reads the paged cross K/V through the read-only
kernel (``kernels.ops.paged_attention``).  ``cfg.fused_paged_attn=False``
takes the plain path instead: scatter, gather the logical view,
``_gqa_core``.  A ring layer's chunk step, the contiguous cache (decode
and chunk step), the encoder and the legacy bucketed prefill attend
through ``_gqa_core``, as the JAX package does outside its kernels.
Caches are updated in place.
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


def _additive(ok):
    """Additive fp32 mask: 0 where `ok`, NEG_INF elsewhere."""
    return torch.where(ok, 0.0, common.NEG_INF).to(torch.float32)


def _ring_positions(idx, win: int):
    """(B, win) absolute position each ring slot holds once row b has
    written position idx[b]: slot s holds ``idx - ((idx - s) mod win)``
    (negative: not written yet)."""
    s = torch.arange(win, device=idx.device)[None, :]
    return idx[:, None] - torch.remainder(idx[:, None] - s, win)


def _chunk_write(cache_kv, wpos, val, write_ok, page_table=None):
    """Scatter a (B, C) chunk of K or V rows into the cache in place: lane
    (b, c) writes position wpos[b, c] iff write_ok[b, c].  Contiguous caches
    index (row, position); paged ones resolve (block, offset) through
    `page_table`.  Dropped lanes are left out before the scatter, and ring
    callers pass wrapped positions with one writer per slot: a scatter with
    duplicate indices has no defined winner on CUDA."""
    b, c = torch.nonzero(write_ok, as_tuple=True)
    pos = wpos.long()[b, c]
    rows = val[b, c].to(cache_kv.dtype)
    if page_table is None:
        cache_kv.index_put_((b, pos), rows)
    else:
        bs = cache_kv.shape[1]
        cache_kv.index_put_((page_table.long()[b, pos // bs], pos % bs), rows)
    return cache_kv


def _chunk_attend(q, k, v, cache, mask, *, start, ntok, positions, active,
                  page_table, page_len: int, ring: bool, win: int,
                  cfg: ModelConfig):
    """Chunked mixed prefill+decode cache update + attention for one layer:
    row b's first ntok[b] lanes are real tokens at positions start[b] ..;
    the rest are padding (writes dropped).

    * Global (non-ring) layers write, then attend: through the prefill
      kernel on a paged cache, over the caller's mask on a contiguous one
      (or a gathered paged view on the plain path).
    * Ring layers: a chunk's writes can overwrite window positions an
      earlier lane still needs, so the row attends ``[pre-write ring view |
      fresh chunk]`` with ring position masks, and of the lanes that wrap
      to one slot only the last writes.

    Returns (y, cache, kv_read_elems)."""
    B, C = positions.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    j = torch.arange(C, device=positions.device)[None, :]
    valid = j < ntok[:, None]
    qj = torch.minimum(j, ntok[:, None] - 1)
    qpos = start[:, None] + qj
    write_ok = valid if active is None else valid & active[:, None]
    if not ring:
        _chunk_write(cache["k"], positions, k, write_ok, page_table)
        _chunk_write(cache["v"], positions, v, write_ok, page_table)
        kv_reads = _visible_chunk_kv_elems(mask, valid, KV, hd)
        if page_table is None:
            return (_gqa_core(q, cache["k"], cache["v"], mask, cfg), cache,
                    kv_reads)
        if cfg.fused_paged_attn:
            y = kops.paged_prefill(q, cache["k"], cache["v"], page_table,
                                   qpos, softcap=float(cfg.attn_softcap or 0.0))
            return y.to(cache["k"].dtype), cache, kv_reads
        k_att = paged_gather(cache["k"], page_table, page_len)
        v_att = paged_gather(cache["v"], page_table, page_len)
        return _gqa_core(q, k_att, v_att, mask, cfg), cache, kv_reads

    if page_table is not None:
        k_old = paged_gather(cache["k"], page_table, win)
        v_old = paged_gather(cache["v"], page_table, win)
    else:
        k_old, v_old = cache["k"], cache["v"]
    # the concatenation copies the pre-write view before the writes land
    k_att = torch.cat([k_old, k.to(k_old.dtype)], dim=1)
    v_att = torch.cat([v_old, v.to(v_old.dtype)], dim=1)
    write_ok = write_ok & (j >= ntok[:, None] - win)      # last writer wins
    wpos = torch.remainder(positions, win)
    _chunk_write(cache["k"], wpos, k, write_ok, page_table)
    _chunk_write(cache["v"], wpos, v, write_ok, page_table)
    # pre-chunk slot s holds position p(s) (start == 0: all negative)
    p_old = _ring_positions(start - 1, win)                     # (B, win)
    ok_old = ((p_old[:, None, :] >= 0)
              & (qpos[:, :, None] - p_old[:, None, :] < win))   # (B, C, win)
    i = torch.arange(C, device=positions.device)[None, None, :]
    ok_new = (i <= qj[:, :, None]) & (qj[:, :, None] - i < win)  # (B, C, C)
    mask_cat = _additive(torch.cat([ok_old, ok_new], dim=-1))[:, None]
    kv_reads = _visible_chunk_kv_elems(mask_cat, valid, KV, hd)
    return _gqa_core(q, k_att, v_att, mask_cat, cfg), cache, kv_reads


def self_attention(params, x, cfg: ModelConfig, *, positions, mask,
                   ctx: Ctx, tag: str, cache=None, cache_index=None,
                   active=None, page_table=None, page_len: int = 0,
                   page_ring: bool = False, chunk_lens=None):
    """Self-attention.

    No cache (the encoder): x (B, S, D) attends within itself under `mask`.
    Prefill (``cache_index`` None): x (B, S, D) fills the contiguous cache
    ``{"k", "v"}`` and attends within the prompt; a ring cache (a
    sliding-window layer whose cache is its window, ``cfg.sliding_window``
    slots) keeps the last window of positions at slots ``p mod window``.
    Decode (``chunk_lens`` None): x (B, 1, D), ``cache_index`` (B,) write
    positions; inactive rows write nothing.  Chunk step: x (B, C, D) with
    ``chunk_lens`` (B,) real lanes per row, ``cache_index`` the per-row
    start, ``positions`` (B, C).  With `page_table` (B, T) int32 and
    `page_len` the cache is paged (the clamped global view, or the window
    of a ring table when `page_ring`); without it, contiguous.  Returns
    (y, aux, cache) with the cache's tensors updated in place (None without
    a cache)."""
    q, k, v, aux = _project_qkv(params, x, cfg, ctx, tag)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    KV, hd, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    B = x.shape[0]
    idx = cache_index
    win = cfg.sliding_window
    ring = cache is not None and bool(win) and cache["k"].shape[1] == win
    if cache is None or idx is None:
        if cache is not None:
            S = k.shape[1]
            for key, t in (("k", k), ("v", v)):
                if ring and S >= win:
                    # the last window, at slots (pos mod win)
                    cache[key].copy_(torch.roll(t[:, S - win:],
                                                (S - win) % win, dims=1))
                else:
                    cache[key][:, :S] = t.to(cache[key].dtype)
        y = _gqa_core(q, k, v, mask, cfg)
    elif chunk_lens is not None:
        y, cache, reads = _chunk_attend(
            q, k, v, cache, mask, start=idx, ntok=chunk_lens,
            positions=positions, active=active, page_table=page_table,
            page_len=page_len,
            ring=page_ring if page_table is not None else ring, win=win,
            cfg=cfg)
        aux["kv_reads"] = aux["kv_reads"] + reads
    elif page_table is not None:
        L = page_len
        if page_ring:
            wpos = torch.remainder(idx, L)
            mask_rows = _additive(_ring_positions(idx, L) >= 0)
        else:
            wpos = idx
            mask_rows = mask.reshape(B, L)
        aux["kv_reads"] = aux["kv_reads"] + _visible_kv_elems(mask_rows, KV,
                                                              hd)
        if cfg.fused_paged_attn:
            out, _, _ = kops.paged_attention_decode(
                q[:, 0].reshape(B, KV, H // KV, hd), cache["k"], cache["v"],
                page_table, mask_rows, k[:, 0], v[:, 0], wpos, active,
                softcap=float(cfg.attn_softcap or 0.0))
            y = out.reshape(B, 1, H * hd).to(cache["k"].dtype)
        else:
            _paged_write(cache["k"], page_table, wpos, k[:, 0], active)
            _paged_write(cache["v"], page_table, wpos, v[:, 0], active)
            y = _gqa_core(q, paged_gather(cache["k"], page_table, L),
                          paged_gather(cache["v"], page_table, L),
                          mask_rows[:, None, None, :], cfg)
    else:
        rows = torch.arange(B, device=x.device)
        if active is not None:
            rows = rows[active]
        wpos = torch.remainder(idx, win) if ring else idx
        for key, t in (("k", k), ("v", v)):
            cache[key].index_put_((rows, wpos.long()[rows]),
                                  t[rows, 0].to(cache[key].dtype))
        if ring:
            mask = _additive(_ring_positions(idx, win) >= 0)[:, None, None, :]
        if mask is not None:
            aux["kv_reads"] = aux["kv_reads"] + _visible_kv_elems(mask, KV,
                                                                  hd)
        y = _gqa_core(q, cache["k"], cache["v"], mask, cfg)
    o, a = emt_dense(params["wo"], y, cfg.emt_at(f"{tag}/wo"),
                     tag=f"{tag}/wo", seed=ctx.seed)
    return o, add_aux(aux, a), cache


def cross_attention(params, x, cfg: ModelConfig, *, enc_out=None,
                    enc_mask=None, ctx: Ctx, tag: str, cache=None,
                    page_table=None, page_len: int = 0):
    """Encoder-decoder cross attention.

    Prefill (`enc_out` given): K/V projected from `enc_out` (B, S_enc, D);
    returns the new ``{"ck", "cv"}`` of the encoder's length.  Decode
    (`enc_out` None, `cache` holding ``ck``/``cv``): the cross K/V written
    once at admission are read, contiguous or through the block table
    (read-only), under `enc_mask` (B, 1, 1, L), the rows of each slot's
    real encoder positions (None: every position); ``kv_reads`` books the
    visible positions.  Returns (y, aux, new cross K/V or None)."""
    aux = new_aux()
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, a = emt_dense(params["wq"], x, cfg.emt_at(f"{tag}/wq"),
                     tag=f"{tag}/wq", seed=ctx.seed)
    aux = add_aux(aux, a)
    q = q.reshape(*x.shape[:-1], H, hd)
    new_cache = None
    if enc_out is None and page_table is None:
        k, v = cache["ck"], cache["cv"]
        vis = (enc_mask if enc_mask is not None
               else torch.zeros((x.shape[0], k.shape[1]), dtype=torch.float32,
                                device=x.device))
        aux["kv_reads"] = aux["kv_reads"] + _visible_kv_elems(vis, KV, hd)
        y = _gqa_core(q, k, v, enc_mask, cfg)
    elif enc_out is None:
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
