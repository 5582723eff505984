"""Technique B: energy regularization (paper Eq. 13), port of
:mod:`repro.core.regularizer`.

``rho`` is a trainable per-layer energy coefficient, softplus-parametrized;
the layer term is ``alpha * rho * sum|w|``.
"""
from __future__ import annotations

import numpy as np
import torch

RHO_MIN = 1e-3


def rho_init_raw(rho0: float) -> float:
    """Inverse softplus so that softplus(raw) + RHO_MIN == rho0."""
    x = max(rho0 - RHO_MIN, 1e-6)
    return float(np.log(np.expm1(x))) if x < 30 else float(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) in the form jax.nn.softplus evaluates it
    (logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def rho_from_raw(rho_raw: torch.Tensor) -> torch.Tensor:
    return softplus(rho_raw) + RHO_MIN


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the derivative JAX gives it: +1 at x = 0 (lax.abs's JVP
    selects g where x >= 0), where torch.abs gives 0.  Quantized weights
    hold exact zeros, so technique B's gradient differs there otherwise."""
    return torch.where(x >= 0, x, -x)


def layer_reg_term(w: torch.Tensor, rho: torch.Tensor, alpha: float):
    """alpha * rho * sum|w|, differentiable in both w and rho."""
    return alpha * rho * torch.sum(jax_abs(w.to(torch.float32)))

