"""The serving config as ``repro.serve.spec.ServeSpec.build_config``
resolves it, for the port's slices: float32 serving, the published stack
(sliding-window ring layers beside global ones) or, with ``all_global``,
every layer global, one EMT corner (`mode`, `device`) or a named device
placement, and optionally per-row DAC scales."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import PLACEMENTS, get_config
from repro_torch.core.device import get_device
from repro_torch.core.placement import map_corners


def build_config(arch: str = "gemma3-1b", mode: str = "analog", *,
                 smoke: bool = True, device: str | None = None,
                 placement: str | None = None, all_global: bool = False,
                 a_per_row: bool = False, prefix_cache: bool = False,
                 model_overrides=None):
    """`placement` names a preset from PLACEMENTS and replaces `mode` and
    `device` (a placement names its corners per layer).  `all_global`
    coerces sliding-window layers to global attention; `prefix_cache`
    (the engine option the config must allow) refuses a stack that keeps
    ring layers."""
    if placement is not None:
        if device is not None:
            raise ValueError("placement and device are mutually exclusive "
                             "(a placement names its corners per layer)")
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}; known: "
                             f"{sorted(PLACEMENTS)}")
        cfg = get_config(arch, smoke=smoke, placement=placement)
    else:
        if device is not None:
            try:
                get_device(device)
            except KeyError as e:
                raise ValueError(f"unknown device corner {device!r}") from e
        cfg = get_config(arch, emt_mode=mode, smoke=smoke, device=device)
    cfg = cfg.replace(dtype=torch.float32)
    has_ring = bool(cfg.sliding_window) and "local" in cfg.blocks()
    if all_global and has_ring:
        cfg = cfg.replace(layer_pattern=("attn",), sliding_window=0)
        has_ring = False
    if prefix_cache and has_ring:
        raise ValueError(
            "prefix_cache requires an all-global attention stack (ring K/V "
            "is positional and cannot be shared) — set all_global=True or "
            "pick a stack without sliding windows")
    if model_overrides:
        cfg = cfg.replace(**model_overrides)
    if a_per_row:
        cfg = cfg.replace(emt=_quant_per_row(cfg.emt))
    return cfg


def _quant_per_row(emt):
    """Switch every corner of an EMT surface to per-row DAC scales."""
    return map_corners(emt, lambda e: e.replace(
        quant=dataclasses.replace(e.quant, a_per_row=True)))
