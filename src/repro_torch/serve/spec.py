"""The serving config as ``repro.serve.spec.ServeSpec.build_config``
resolves it, for the port's slice: float32 serving, an all-global stack
(sliding-window ring layers are ported with a later slice, ROADMAP Queue 1)
and optionally per-row DAC scales."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config


def build_config(arch: str = "gemma3-1b", mode: str = "analog", *,
                 smoke: bool = True, device: str | None = None,
                 a_per_row: bool = False, model_overrides=None):
    cfg = get_config(arch, emt_mode=mode, smoke=smoke, device=device)
    cfg = cfg.replace(dtype=torch.float32)
    if cfg.sliding_window and "local" in cfg.blocks():
        cfg = cfg.replace(layer_pattern=("attn",), sliding_window=0)
    if model_overrides:
        cfg = cfg.replace(**model_overrides)
    if a_per_row:
        emt = cfg.emt
        cfg = cfg.replace(emt=emt.replace(
            quant=dataclasses.replace(emt.quant, a_per_row=True)))
    return cfg
