"""Technique A: device-enhanced fluctuation sampling, port of
:mod:`repro.core.noise` (``hash`` backend).

Every read of a stored weight returns ``w * (1 + a_l * sigma_rel(rho))``
with the RTN state drawn from the counter hash of
``(seed, plane, row, col)``, bit-exact with the JAX reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import hashrng
from repro_torch.core.device import DeviceModel


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    backend: str = "hash"          # "hash" | "threefry"
    granularity: str = "per_step"  # "per_step" | "per_read"
    enabled: bool = True


def sample_state_offsets_hash(seed, shape, device: DeviceModel, plane=0,
                              row0=0, col0=0, *, on="cpu") -> torch.Tensor:
    """Counter-hash state sampling.  The 2-D tail of `shape` is hashed over
    (row, col); leading dims fold into the plane counter so every batch
    slice gets independent draws."""
    shape = tuple(int(s) for s in shape)
    offs, probs = device.state_offsets, device.state_probs
    if len(shape) == 1:
        return hashrng.tile_state_offsets(seed, row0, col0, (1,) + shape,
                                          offs, probs, plane, device=on)[0]
    if len(shape) == 2:
        return hashrng.tile_state_offsets(seed, row0, col0, shape, offs,
                                          probs, plane, device=on)
    lead = math.prod(shape[:-2])
    planes = [hashrng.tile_state_offsets(seed, row0, col0, shape[-2:], offs,
                                         probs, plane * 131071 + i + 1,
                                         device=on)
              for i in range(lead)]
    return torch.stack(planes).reshape(shape)


def noise_factor(offs: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """float32(1 + a * sigma): the multiplicative read factor, rounded as
    the JAX reference rounds it (product, then sum, each in float32)."""
    return 1.0 + offs * sig


def fluctuate(w: torch.Tensor, rho: torch.Tensor, device: DeviceModel,
              cfg: NoiseConfig, *, seed=0, plane=0) -> torch.Tensor:
    """The sampled read value w~ = r_l(w, rho) (technique A forward), the
    noise materialized as a weight-sized tensor (the plain version of the
    fused kernel in kernels/emt_matmul.py)."""
    if not cfg.enabled:
        return w
    if cfg.backend != "hash":
        raise NotImplementedError(
            f"noise backend {cfg.backend!r}: only the hash backend is ported "
            f"(threefry comes with a later slice, ROADMAP Queue 1)")
    offs = sample_state_offsets_hash(seed, w.shape, device, plane=plane,
                                     on=w.device).detach()
    sig = device.sigma_rel(rho)
    return w * noise_factor(offs, sig).to(w.dtype)
