"""Technique A: device-enhanced fluctuation sampling, port of
:mod:`repro.core.noise`.

Every read of a stored weight returns ``w * (1 + a_l * sigma_rel(rho))``
with the RTN state l drawn by one of two backends:

* ``hash``: the counter hash of ``(seed, plane, row, col)``, bit-exact with
  the JAX reference and with the fused kernels (no noise tensor in memory);
* ``threefry``: the paper-faithful categorical draw from ``state_probs``
  on an explicit ``torch.Generator`` (JAX draws it with
  ``jax.random.categorical`` from a threefry key; the streams cannot match,
  the marginals do).  The noise is a weight-sized tensor.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional

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


def fold_in(gen: torch.Generator, data: int, device=None) -> torch.Generator:
    """A generator derived deterministically from `gen`'s current state and
    `data` (JAX's ``fold_in(key, data)``): the same state and data give the
    same stream; `gen` is not advanced.  The new generator lives on
    `device` (default: `gen`'s)."""
    h = hashlib.sha256(gen.get_state().cpu().numpy().tobytes()
                       + int(data).to_bytes(8, "little", signed=False))
    child = torch.Generator(device=gen.device if device is None else device)
    child.manual_seed(int.from_bytes(h.digest()[:8], "little") >> 1)
    return child


def sample_state_offsets_threefry(gen: torch.Generator, shape,
                                  device: DeviceModel,
                                  on=None) -> torch.Tensor:
    """Paper-faithful categorical state sampling on `gen`: state i with
    probability ``state_probs[i]`` (the inverse CDF of a float64 uniform),
    looked up in ``state_offsets``.  float32, on `on` (default: `gen`'s
    device)."""
    on = gen.device if on is None else torch.device(on)
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float64,
                   device=on)
    cdf = torch.cumsum(torch.as_tensor(device.state_probs,
                                       dtype=torch.float64, device=on), 0)
    state = torch.clamp(torch.searchsorted(cdf, u, right=True),
                        max=len(cdf) - 1)
    table = torch.as_tensor(device.state_offsets, dtype=torch.float32,
                            device=on)
    return table[state]


def noise_factor(offs: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """float32(1 + a * sigma): the multiplicative read factor, rounded as
    the JAX reference rounds it (product, then sum, each in float32)."""
    return 1.0 + offs * sig


def fluctuate(w: torch.Tensor, rho: torch.Tensor, device: DeviceModel,
              cfg: NoiseConfig, *, key: Optional[torch.Generator] = None,
              seed=0, plane=0) -> torch.Tensor:
    """The sampled read value w~ = r_l(w, rho) (technique A forward), the
    noise materialized as a weight-sized tensor (the hash backend's is the
    plain version of the fused kernel in kernels/emt_matmul.py).  The
    threefry backend draws from `key` (a generator the caller has already
    derived for this layer, as JAX folds the plane into its key)."""
    if not cfg.enabled:
        return w
    if cfg.backend == "threefry":
        if key is None:
            raise ValueError("threefry backend needs a PRNG key")
        offs = sample_state_offsets_threefry(key, w.shape, device,
                                             on=w.device)
    elif cfg.backend == "hash":
        offs = sample_state_offsets_hash(seed, w.shape, device, plane=plane,
                                         on=w.device)
    else:
        raise ValueError(f"unknown noise backend {cfg.backend!r}")
    offs = offs.detach()
    sig = device.sigma_rel(rho)
    return w * noise_factor(offs, sig).to(w.dtype)
