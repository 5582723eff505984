"""Config helpers: the EMT preset and smoke-scale reduction (port of
:mod:`repro.configs.common`)."""
from __future__ import annotations

import torch

from repro_torch.core.device import DeviceModel, get_device
from repro_torch.core.emt_linear import EMTConfig, IDEAL
from repro_torch.core.noise import NoiseConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.models.config import ModelConfig


def emt_preset(mode: str = "analog", rng: str = "hash",
               intensity: str = "normal", rho_init: float = 4.0,
               energy_accounting: str = "full",
               device: str | None = None) -> EMTConfig:
    """The standard EMT configuration; `device` names a registered corner
    (None: the paper's default cell)."""
    if mode == "ideal":
        return IDEAL
    dev = get_device(device) if device else DeviceModel()
    return EMTConfig(
        mode=mode,
        quant=QuantConfig(w_bits=8, a_bits=8, enabled=True),
        noise=NoiseConfig(backend=rng, granularity="per_step"),
        device=dev.with_intensity(intensity),
        rho_init=rho_init,
        energy_accounting=energy_accounting,
        corner=device or "",
    )


def shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family smoke config: tiny widths, few layers, fp32."""
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(cfg.num_kv_heads, heads))
    if cfg.num_kv_heads == cfg.num_heads:
        kv = heads
    elif cfg.num_kv_heads == 1:
        kv = 1
    kw = dict(
        num_layers=min(cfg.num_layers, max(2, len(cfg.layer_pattern))),
        d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128, vocab_size=512,
        sliding_window=8 if cfg.sliding_window else 0, dtype=torch.float32)
    kw.update(overrides)
    return cfg.replace(name=cfg.name + "-smoke", **kw)
