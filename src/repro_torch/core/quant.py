"""Symmetric fake-quantization with straight-through estimators.

Port of :mod:`repro.core.quant`.  The forward values reproduce the JAX
arithmetic exactly, including the straight-through form ``x + (q - x)``
(which need not equal ``q`` in float32).  ``torch.round`` and ``jnp.round``
both round half to even.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    w_bits: int = 8
    a_bits: int = 8
    enabled: bool = True
    per_channel: bool = True
    # per-row (per-token) activation DAC scale: quantization never couples
    # co-tenant batch rows
    a_per_row: bool = False


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through: forward value x + (q - x), backward identity."""
    return x + (q - x).detach()


def _amax(x: torch.Tensor, axis):
    if axis is None:
        return torch.amax(torch.abs(x))
    return torch.amax(torch.abs(x), dim=axis, keepdim=True)


def symmetric_scale(x, bits, axis=None, eps=1e-8):
    qmax = 2.0 ** (bits - 1) - 1.0
    return torch.clamp_min(_amax(x, axis), eps) / qmax


def fake_quant(x, bits, axis=None):
    """Quantize-dequantize with STE. Returns (x_q_dequant, scale)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = symmetric_scale(x, bits, axis=axis).detach()
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return _ste(x, q * scale), scale


def quant_levels(x, bits, axis=None):
    """Integer levels (STE form) + scale; levels in [-qmax, qmax]."""
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = symmetric_scale(x, bits, axis=axis).detach()
    xs = x / scale
    q = torch.clamp(torch.round(xs), -qmax, qmax)
    return _ste(xs, q), scale


def quantize_weights(w, cfg: QuantConfig):
    if not cfg.enabled:
        return w, None
    axis = tuple(range(w.ndim - 1)) if cfg.per_channel else None
    return fake_quant(w, cfg.w_bits, axis=axis)

