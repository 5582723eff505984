"""Decoder-only and encoder-decoder language models for serving (port of
:mod:`repro.models.lm`: specs, the encoder, the legacy ``prefill`` into a
contiguous cache, the paged cache, ``chunk_step`` and ``decode_step``) plus
the port's seeded init and the JAX weight bridge.

Paged caches are dicts of per-layer ``{"k", "v"}`` pools of shape
``(num_blocks + 1, block_size, kv_heads, head_dim)`` (zero block last; a
sliding-window ring layer's pool has ``num_ring_blocks + 1`` rows and pages
through the ring table), with ``{"ck", "cv"}`` cross K/V pools beside them
in an enc-dec stack.  Contiguous caches hold ``(batch, max_len, kv_heads,
head_dim)`` per layer, ``min(window, max_len)`` positions on a ring layer.
The steps update either in place; they take the paged layout when given
``page_tables``/``page_lens``, the contiguous one otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.core import regularizer
from repro_torch.core.emt_linear import add_aux, new_aux
from repro_torch.models import common
from repro_torch.models import stack as stk
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.nn.param import (ParamSpec, constant_init, init_params,
                                  load_arrays)


def specs(cfg: ModelConfig) -> dict:
    s = {
        "embed": common.embedding_specs(cfg.vocab_size, cfg.d_model,
                                        cfg.dtype),
        "decoder": stk.stack_specs(cfg, cfg.num_layers, cfg.blocks(),
                                   cross=cfg.is_encdec, tag="dec"),
        "final_norm": common.rmsnorm_specs(cfg.d_model),
    }
    head_emt = cfg.emt_at("unembed")
    if not cfg.tie_embeddings:
        s["lm_head"] = common.unembed_specs(cfg.d_model, cfg.vocab_size,
                                            head_emt, cfg.dtype)
    elif head_emt.active:
        # the tied table is the crossbar; it still has an energy coefficient
        s["lm_head"] = {"rho_raw": ParamSpec(
            (), torch.float32,
            constant_init(regularizer.rho_init_raw(head_emt.rho_init)))}
    if cfg.is_encdec:
        s["encoder"] = stk.stack_specs(cfg, cfg.encoder_layers,
                                       ("attn",) * cfg.encoder_layers,
                                       tag="enc")
        s["enc_norm"] = common.rmsnorm_specs(cfg.d_model)
    return s


def init_model_params(cfg: ModelConfig, seed: int, device="cuda"):
    """Full-width random weights from `seed` with the port's own init."""
    return init_params(specs(cfg), seed, device)


def load_jax_arrays(arrays: dict, cfg: ModelConfig, device="cuda"):
    """Parameters from the by-path numpy dict of a JAX parameter tree (keys
    as ``repro.utils.pytrees.flatten_with_paths`` names them, the format
    ``repro/ckpt/checkpoint.py::_tree_to_arrays`` produces).  Missing or
    unexpected paths and shape mismatches raise."""
    return load_arrays(specs(cfg), arrays, device)


def _encode(params, batch, cfg: ModelConfig, ctx: Ctx):
    """Bidirectional encoder over ``batch["enc_embeds"]`` (B, S, D), the
    speech front end's frame embeddings (a stub), or the embedded
    ``batch["enc_tokens"]``.  Returns (enc_out, positions, aux)."""
    enc_x = batch.get("enc_embeds")
    if enc_x is None:
        enc_x = common.embed(params["embed"], batch["enc_tokens"],
                             cfg.embed_scale, cfg.d_model)
    enc_x = enc_x.to(cfg.dtype)
    B, S = enc_x.shape[:2]
    pos = torch.arange(S, device=enc_x.device)[None].expand(B, S)
    valid = torch.ones((B, S), dtype=torch.bool, device=enc_x.device)
    y, aux, _ = stk.apply_stack(
        params["encoder"], enc_x, cfg, ("attn",) * cfg.encoder_layers,
        ctx=ctx, tag="enc", positions=pos,
        mask=common.full_mask(valid, valid))
    return common.rmsnorm(params["enc_norm"], y, cfg.norm_eps), pos, aux


def _logits(params, h, cfg: ModelConfig, ctx: Ctx):
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    y, aux = common.unembed(params.get("lm_head", {}), h,
                            cfg.emt_at("unembed"), tied_table=tied,
                            seed=ctx.seed)
    return common.softcap(y.to(cfg.logit_dtype), cfg.final_softcap), aux


def paged_lens(cfg: ModelConfig, max_len: int) -> dict:
    """Logical per-slot cache lengths of the paged layout.  Sliding-window
    layers hold ``min(window, max_len)`` positions (the contiguous rule of
    ``stack.block_state_specs``); when the window does not shrink the cache
    they share the global table (``ring`` False, lengths equal).  The
    explicit ``ring`` flag, not equal lengths, routes local layers to the
    ring table: the engine's per-step clamp of the global view
    (:func:`clamped_lens`) can make the global length equal the window."""
    ring = min(cfg.sliding_window, max_len) if cfg.sliding_window else 0
    has_ring = bool(ring and ring < max_len and "local" in cfg.blocks())
    return {"global": max_len, "local": ring if has_ring else max_len,
            "ring": has_ring}


def clamped_lens(page_lens_full: dict, view_len: int) -> dict:
    """Clamp the global logical view to ``view_len`` positions; ring layers
    keep their window-sized view."""
    lens = dict(page_lens_full)
    lens["global"] = min(int(view_len), page_lens_full["global"])
    if not lens["ring"]:
        lens["local"] = lens["global"]
    return lens


def ring_layers(cfg: ModelConfig, page_lens: dict) -> frozenset:
    """Names of the layers whose K/V page through the ring table."""
    if not page_lens["ring"]:
        return frozenset()
    return frozenset(f"layer_{i:03d}" for i, kind in enumerate(cfg.blocks())
                     if kind == "local")


def _zeros(shapes: dict, dtype, device):
    from repro_torch import resolve_device
    dev = resolve_device(device)
    return {k: torch.zeros(s, dtype=dtype, device=dev)
            for k, s in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Zeroed contiguous cache: per layer ``k``/``v`` (batch, length, KV,
    hd), length max_len, or ``min(window, max_len)`` slots for a
    sliding-window layer (a ring: position p at slot p mod window), plus
    ``ck``/``cv`` of max_len positions in an enc-dec stack."""
    return {f"layer_{i:03d}": _zeros(
        stk.block_state_specs(cfg, kind, batch, max_len,
                              cross_len=max_len if cfg.is_encdec else 0),
        cfg.dtype, device) for i, kind in enumerate(cfg.blocks())}


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     block_size: int, num_blocks: int,
                     num_ring_blocks: int = 0, device="cuda"):
    """Zeroed block pools for every attention layer, ``(num_blocks + 1,
    block_size, KV, hd)`` (zero block last), or ``num_ring_blocks + 1``
    rows for a ring layer (:func:`paged_lens`); an enc-dec stack's cross
    K/V (``ck``/``cv``) page through the global table."""
    ring = ring_layers(cfg, paged_lens(cfg, max_len))
    kv = (block_size, cfg.num_kv_heads, cfg.head_dim)
    cache = {}
    for i in range(cfg.num_layers):
        name = f"layer_{i:03d}"
        rows = (num_ring_blocks if name in ring else num_blocks) + 1
        shapes = dict.fromkeys(("k", "v"), (rows,) + kv)
        if cfg.is_encdec:
            shapes.update(dict.fromkeys(("ck", "cv"), (num_blocks + 1,) + kv))
        cache[name] = _zeros(shapes, cfg.dtype, device)
    return cache


def prefill(params, batch, cfg: ModelConfig, ctx: Ctx, cache):
    """Run ``batch["tokens"]`` (B, S) through the model (and, enc-dec, the
    encoder over ``batch["enc_embeds"]``), filling positions [0, S) of the
    contiguous `cache` in place.  Returns (cache, last-token logits
    (B, vocab), aux); an enc-dec cache's ``ck``/``cv`` come back at the
    encoder's length S, not max_len."""
    x = common.embed(params["embed"], batch["tokens"], cfg.embed_scale,
                     cfg.d_model).to(cfg.dtype)
    B, S = x.shape[:2]
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    # prefill attends within the prompt (the unfilled cache tail would be
    # masked anyway)
    masks = {"global": common.causal_mask(pos, pos),
             "local": common.causal_mask(pos, pos, cfg.sliding_window)}
    enc_out = enc_mask = None
    aux = new_aux()
    if cfg.is_encdec:
        enc_out, enc_pos, a = _encode(params, batch, cfg, ctx)
        aux = add_aux(aux, a)
        enc_mask = common.full_mask(
            torch.ones((B, S), dtype=torch.bool, device=x.device),
            torch.ones(enc_pos.shape, dtype=torch.bool, device=x.device))
    h, a, cache = stk.apply_stack(
        params["decoder"], x, cfg, cfg.blocks(), ctx=ctx, tag="dec",
        positions=pos, mask=masks, caches=cache, enc_out=enc_out,
        enc_mask=enc_mask)
    aux = add_aux(aux, a)
    h = common.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    logits, a = _logits(params, h, cfg, ctx)
    return cache, logits[:, 0], add_aux(aux, a)


def _cache_len(cache) -> int:
    """The contiguous cache's longest K/V (ring layers hold fewer)."""
    return max((blk["k"].shape[1] for blk in cache.values() if "k" in blk),
               default=1)


def _masks(cfg: ModelConfig, qpos, L: int):
    B = qpos.shape[0]
    k_pos = torch.arange(L, device=qpos.device)[None].expand(B, L)
    return {"global": common.causal_mask(qpos, k_pos),
            "local": common.causal_mask(qpos, k_pos, cfg.sliding_window)}


def chunk_step(params, cache, tokens, start, ntok, cfg: ModelConfig,
               ctx: Ctx, active=None, page_tables=None, page_lens=None):
    """One mixed prefill+decode step over a (B, C) token chunk: row b
    advances by ntok[b] tokens at positions start[b] .. start[b] + ntok[b]
    - 1 (padding lanes past ntok[b] are dropped).  `page_tables`
    ``{"global": (B, Tg), "local": (B, Tl)}`` int32 and `page_lens`
    (:func:`clamped_lens`) select the paged layout; without them the cache
    is contiguous.  Returns (last real lane's logits (B, vocab), cache,
    aux)."""
    B, C = tokens.shape
    x = common.embed(params["embed"], tokens, cfg.embed_scale,
                     cfg.d_model).to(cfg.dtype)
    j = torch.arange(C, device=tokens.device)[None, :]
    wpos = start[:, None] + j
    qpos = start[:, None] + torch.minimum(j, ntok[:, None] - 1)
    L = page_lens["global"] if page_lens else _cache_len(cache)
    masks = _masks(cfg, qpos, L)
    h, aux, cache = stk.apply_stack(
        params["decoder"], x, cfg, cfg.blocks(), ctx=ctx, tag="dec",
        positions=wpos, mask=masks, caches=cache, cache_index=start,
        active=active, page_tables=page_tables, page_lens=page_lens,
        chunk_lens=ntok)
    idx = (ntok.long() - 1)[:, None, None].expand(B, 1, h.shape[-1])
    h_last = common.rmsnorm(params["final_norm"], torch.gather(h, 1, idx),
                            cfg.norm_eps)
    logits, a = _logits(params, h_last, cfg, ctx)
    return logits[:, 0], cache, add_aux(aux, a)


def decode_step(params, cache, tokens, index, cfg: ModelConfig, ctx: Ctx,
                active=None, page_tables=None, page_lens=None, enc_lens=None):
    """One decode step: `tokens` (B,) generated at positions `index` (B,);
    inactive rows leave the cache untouched.  `page_tables`/`page_lens` as
    in :func:`chunk_step`.  `enc_lens` (B,) masks an
    enc-dec stack's cross attention to each row's real encoder positions
    (the cross K/V pools hold zeros past them; a row of length 0 attends
    nothing and gets zeros).  Returns (logits (B, vocab), cache, aux)."""
    B = tokens.shape[0]
    x = common.embed(params["embed"], tokens[:, None], cfg.embed_scale,
                     cfg.d_model).to(cfg.dtype)
    pos = index[:, None]
    L = page_lens["global"] if page_lens else _cache_len(cache)
    masks = _masks(cfg, pos, L)
    enc_mask = None
    if enc_lens is not None and cfg.is_encdec:
        valid_k = (torch.arange(L, device=x.device)[None, :]
                   < enc_lens[:, None])
        enc_mask = common.full_mask(
            torch.ones((B, 1), dtype=torch.bool, device=x.device), valid_k)
    h, aux, cache = stk.apply_stack(
        params["decoder"], x, cfg, cfg.blocks(), ctx=ctx, tag="dec",
        positions=pos, mask=masks, caches=cache, cache_index=index,
        active=active, page_tables=page_tables, page_lens=page_lens,
        enc_mask=enc_mask)
    h = common.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits, a = _logits(params, h, cfg, ctx)
    return logits[:, 0], cache, add_aux(aux, a)
