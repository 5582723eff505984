"""Config helpers: the EMT preset, device placements and smoke-scale
reduction (port of :mod:`repro.configs.common`)."""
from __future__ import annotations

import torch

from repro_torch.core.device import DeviceModel, get_device
from repro_torch.core.emt_linear import EMTConfig, IDEAL
from repro_torch.core.noise import NoiseConfig
from repro_torch.core.placement import (DevicePlacement, LayerRule,
                                        emt_for_corner)
from repro_torch.core.quant import QuantConfig
from repro_torch.models.config import ModelConfig


def emt_preset(mode: str = "analog", rng: str = "hash",
               intensity: str = "normal", rho_init: float = 4.0,
               energy_accounting: str = "full",
               store_int8: bool = False,
               device: str | None = None) -> EMTConfig:
    """The standard EMT configuration; `device` names a registered corner
    (None: the paper's default cell); `store_int8` stores the weights as
    int8 levels + per-column scales (serve-only)."""
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
        store_int8=store_int8,
        corner=device or "",
    )


def mixed_placement(rng: str = "hash") -> DevicePlacement:
    """The worked mixed-technology example (docs/device_models.md): analog
    attention on PCM, bit-serial MLPs/experts on RRAM, routers on digital
    SRAM, everything else (the unembed included) analog PCM.  On a dense
    model the expert and router rules match nothing."""
    noise = NoiseConfig(backend=rng, granularity="per_step")
    pcm = emt_for_corner("pcm", "analog").replace(noise=noise)
    rram_bs = emt_for_corner("rram", "bitserial").replace(noise=noise)
    sram = emt_for_corner("sram_digital", "analog").replace(noise=noise)
    return DevicePlacement(
        rules=(
            LayerRule("*/attn/*", pcm),
            LayerRule("*/xattn/*", pcm),
            LayerRule("*/mlp/*", rram_bs),
            LayerRule("*/moe/experts", rram_bs),
            LayerRule("*/moe/router", sram),
        ),
        default=pcm)


def placement_preset(name: str, rng: str = "hash") -> DevicePlacement:
    """Named placement presets (the values of ``--placement``)."""
    noise = NoiseConfig(backend=rng, granularity="per_step")
    if name == "mixed":
        return mixed_placement(rng)
    if name == "attn-pcm":
        # attention analog on PCM, everything else digital
        return DevicePlacement(
            rules=(LayerRule("*/attn/*", emt_for_corner("pcm", "analog")
                             .replace(noise=noise)),),
            default=IDEAL)
    if name == "digital-router":
        # one global analog config, routers pinned to the digital corner
        return DevicePlacement(
            rules=(LayerRule("*/moe/router",
                             emt_for_corner("sram_digital", "analog")
                             .replace(noise=noise)),),
            default=emt_preset("analog", rng=rng))
    raise KeyError(f"unknown placement preset {name!r}; "
                   f"known: {sorted(PLACEMENTS)}")


PLACEMENTS = ("mixed", "attn-pcm", "digital-router")


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
        sliding_window=8 if cfg.sliding_window else 0,
        encoder_layers=2 if cfg.encoder_layers else 0, dtype=torch.float32)
    kw.update(overrides)
    return cfg.replace(name=cfg.name + "-smoke", **kw)
