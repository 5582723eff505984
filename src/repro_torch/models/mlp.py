"""Gated (GLU) feed-forward block on EMT crossbars."""
from __future__ import annotations

from repro_torch.core.emt_linear import add_aux, dense_specs, emt_dense, new_aux
from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx


def mlp_specs(cfg: ModelConfig, tag: str = "") -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "wg": dense_specs(D, Fd, cfg.emt_at(f"{tag}/wg"), dtype=cfg.dtype),
        "wu": dense_specs(D, Fd, cfg.emt_at(f"{tag}/wu"), dtype=cfg.dtype),
        "wd": dense_specs(Fd, D, cfg.emt_at(f"{tag}/wd"), dtype=cfg.dtype),
    }


def mlp(params, x, cfg: ModelConfig, *, ctx: Ctx, tag: str):
    act = common.activation(cfg.act)
    aux = new_aux()
    g, a = emt_dense(params["wg"], x, cfg.emt_at(f"{tag}/wg"),
                     tag=f"{tag}/wg", seed=ctx.seed, key=ctx.key)
    aux = add_aux(aux, a)
    u, a = emt_dense(params["wu"], x, cfg.emt_at(f"{tag}/wu"),
                     tag=f"{tag}/wu", seed=ctx.seed, key=ctx.key)
    aux = add_aux(aux, a)
    y, a = emt_dense(params["wd"], act(g) * u, cfg.emt_at(f"{tag}/wd"),
                     tag=f"{tag}/wd", seed=ctx.seed, key=ctx.key)
    return y, add_aux(aux, a)
