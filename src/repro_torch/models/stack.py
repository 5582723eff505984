"""Layer stack of attention + GLU blocks (port of :mod:`repro.models.stack`
for the paged serving path)."""
from __future__ import annotations

import torch

from repro_torch.core.emt_linear import add_aux, new_aux
from repro_torch.models import common
from repro_torch.models.attention import attention_specs, self_attention
from repro_torch.models.config import ATTN_KINDS, ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.models.mlp import mlp, mlp_specs


def block_specs(cfg: ModelConfig, kind: str, tag: str = "") -> dict:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is ported with a "
                                  f"later slice")
    specs = {"norm1": common.rmsnorm_specs(cfg.d_model),
             "attn": attention_specs(cfg, tag=f"{tag}/attn")}
    if cfg.d_ff > 0:
        specs["norm2"] = common.rmsnorm_specs(cfg.d_model)
        specs["ffn"] = mlp_specs(cfg, tag=f"{tag}/mlp")
    return specs


def apply_block(params, x, cfg: ModelConfig, *, kind: str, tag: str,
                ctx: Ctx, positions, mask, cache, cache_index, active,
                page_table, page_len: int, chunk_lens=None):
    """One residual block. Returns (y, aux, cache)."""
    h = common.rmsnorm(params["norm1"], x, cfg.norm_eps)
    window = cfg.sliding_window if kind == "local" else 0
    m = mask["local"] if kind == "local" else mask["global"]
    y, aux, cache = self_attention(
        params["attn"], h, cfg.replace(sliding_window=window),
        positions=positions, mask=m, ctx=ctx, tag=f"{tag}/attn", cache=cache,
        cache_index=cache_index, active=active, page_table=page_table,
        page_len=page_len, chunk_lens=chunk_lens)
    x = x + y
    if "ffn" in params:
        h = common.rmsnorm(params["norm2"], x, cfg.norm_eps)
        y, a = mlp(params["ffn"], h, cfg, ctx=ctx, tag=f"{tag}/mlp")
        aux = add_aux(aux, a)
        x = x + y
    return x, aux, cache


def stack_specs(cfg: ModelConfig, num_layers: int, kinds,
                tag: str = "") -> dict:
    return {f"layer_{i:03d}": block_specs(cfg, kinds[i],
                                          tag=f"{tag}/layer_{i:03d}")
            for i in range(num_layers)}


def apply_stack(params, x, cfg: ModelConfig, kinds, *, ctx: Ctx, tag: str,
                positions, mask, caches: dict, cache_index, active=None,
                page_tables=None, page_lens=None, chunk_lens=None):
    """Apply the whole stack (caches: layer name -> {"k", "v"} pools)."""
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
    for i, kind in enumerate(kinds):
        name = f"layer_{i:03d}"
        x, a, _ = apply_block(
            params[name], x, cfg, kind=kind, tag=f"{tag}/{name}", ctx=ctx,
            positions=positions, mask=mask, cache=caches[name],
            cache_index=cache_index, active=active,
            page_table=page_tables["global"], page_len=page_lens["global"],
            chunk_lens=chunk_lens)
        aux = add_aux(aux, a)
        if lane_ok is not None:
            x = torch.where(lane_ok, x, torch.zeros_like(x))
    return x, aux, caches
