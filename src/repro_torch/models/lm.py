"""Decoder-only language model over the paged KV cache (port of
:mod:`repro.models.lm`: specs, the paged cache, ``chunk_step`` and
``decode_step``) plus the port's seeded init and the JAX weight bridge.

Caches are dicts of per-layer ``{"k", "v"}`` pools of shape
``(num_blocks + 1, block_size, kv_heads, head_dim)`` (zero block last),
updated in place by the steps.
"""
from __future__ import annotations

import torch

from repro_torch.core import regularizer
from repro_torch.core.emt_linear import add_aux
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
                                   tag="dec"),
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


def _logits(params, h, cfg: ModelConfig, ctx: Ctx):
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    y, aux = common.unembed(params.get("lm_head", {}), h,
                            cfg.emt_at("unembed"), tied_table=tied,
                            seed=ctx.seed)
    return common.softcap(y.to(cfg.logit_dtype), cfg.final_softcap), aux


def paged_lens(cfg: ModelConfig, max_len: int) -> dict:
    """Logical per-slot cache lengths of the paged layout.  Sliding-window
    layers whose window is shorter than max_len need ring tables, which a
    later slice ports."""
    ring = min(cfg.sliding_window, max_len) if cfg.sliding_window else 0
    if ring and ring < max_len and "local" in cfg.blocks():
        raise NotImplementedError(
            "paged ring tables for sliding-window layers are ported with a "
            "later slice; serve an all-global stack")
    return {"global": max_len}


def clamped_lens(page_lens_full: dict, view_len: int) -> dict:
    """Clamp the global logical view to ``view_len`` positions."""
    return {"global": min(int(view_len), page_lens_full["global"])}


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     block_size: int, num_blocks: int, device="cuda"):
    """Zeroed block pools for every attention layer."""
    from repro_torch import resolve_device
    paged_lens(cfg, max_len)
    dev = resolve_device(device)
    shape = (num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {f"layer_{i:03d}": {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
        for i in range(cfg.num_layers)}


def _masks(cfg: ModelConfig, qpos, L: int):
    B = qpos.shape[0]
    k_pos = torch.arange(L, device=qpos.device)[None].expand(B, L)
    return {"global": common.causal_mask(qpos, k_pos),
            "local": common.causal_mask(qpos, k_pos, cfg.sliding_window)}


def chunk_step(params, cache, tokens, start, ntok, cfg: ModelConfig,
               ctx: Ctx, active=None, page_tables=None, page_lens=None):
    """One mixed prefill+decode step over a (B, C) token chunk: row b
    advances by ntok[b] tokens at positions start[b] .. start[b] + ntok[b]
    - 1 (padding lanes past ntok[b] are dropped).  Returns (last real lane's
    logits (B, vocab), cache, aux)."""
    B, C = tokens.shape
    x = common.embed(params["embed"], tokens, cfg.embed_scale,
                     cfg.d_model).to(cfg.dtype)
    j = torch.arange(C, device=tokens.device)[None, :]
    wpos = start[:, None] + j
    qpos = start[:, None] + torch.minimum(j, ntok[:, None] - 1)
    masks = _masks(cfg, qpos, page_lens["global"])
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
                active=None, page_tables=None, page_lens=None):
    """One decode step: `tokens` (B,) generated at positions `index` (B,);
    inactive rows leave the cache untouched.  Returns (logits (B, vocab),
    cache, aux)."""
    x = common.embed(params["embed"], tokens[:, None], cfg.embed_scale,
                     cfg.d_model).to(cfg.dtype)
    pos = index[:, None]
    masks = _masks(cfg, pos, page_lens["global"])
    h, aux, cache = stk.apply_stack(
        params["decoder"], x, cfg, cfg.blocks(), ctx=ctx, tag="dec",
        positions=pos, mask=masks, caches=cache, cache_index=index,
        active=active, page_tables=page_tables, page_lens=page_lens)
    h = common.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits, a = _logits(params, h, cfg, ctx)
    return logits[:, 0], cache, add_aux(aux, a)
