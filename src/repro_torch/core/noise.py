"""Technique A: device-enhanced fluctuation sampling, port of
:mod:`repro.core.noise`.

Every read of a stored weight returns ``w * (1 + a_l * sigma_rel(rho))``
with the RTN state l drawn by one of two backends:

* ``hash``: the counter hash of ``(seed, plane, row, col)``, bit-exact with
  the JAX reference and with the fused kernels (no noise tensor in memory);
* ``threefry``: the paper-faithful categorical draw from ``state_probs``,
  ``jax.random.categorical`` as JAX computes it from a threefry key:
  threefry2x32 bits (the partitionable counter scheme), a Gumbel per state
  and the argmax of Gumbel + log-probability.  The key is JAX's raw key
  data, a pair of uint32 words (:func:`prng_key`, :func:`fold_in`).  The
  bits equal JAX's bit for bit; the two ``log`` of the Gumbel step are
  the only inexact part (XLA's CPU ``log`` is a polynomial of its own),
  so a state can differ only where two states' Gumbel + logit lie within
  a few ulp.  The noise is a weight-sized tensor.

The threefry arithmetic runs in int64 holding uint32 values, masked back
to 32 bits after every add and shift, as :mod:`repro_torch.core.hashrng`
does for the hash.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np

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


# a threefry key: JAX's raw key data, two uint32 words
Key = Union[Sequence[int], np.ndarray, torch.Tensor]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_words(key: Key) -> tuple:
    """The key's two uint32 words as Python ints (a tuple, a list, a numpy
    array or a tensor of two integers, e.g. ``jax.random.PRNGKey(s)``'s
    data)."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    k0, k1 = (int(v) & _MASK for v in np.asarray(key).reshape(-1).tolist())
    return k0, k1


def prng_key(seed: int) -> tuple:
    """The key words of ``jax.random.PRNGKey(seed)`` (x64 off): a seed in
    32-bit range is (0, seed mod 2^32), a wider one its high and low
    words."""
    seed = int(seed)
    if -2 ** 31 <= seed < 2 ** 32:
        return 0, seed & _MASK
    return (seed >> 32) & _MASK, seed & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) of the counter pairs
    (x0, x1) under `key`, as ``jax._src.prng.threefry2x32_p`` computes it:
    int64 tensors holding uint32 values in, the two output words out."""
    k0, k1 = key_words(key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(key: Key, data: int) -> tuple:
    """``jax.random.fold_in(key, data)``: the key words of threefry2x32
    under `key` of the counter pair (0, data mod 2^32)."""
    y0, y1 = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _MASK]))
    return int(y0), int(y1)


def random_bits(key: Key, shape, on="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` under the partitionable
    threefry scheme (``jax_threefry_partitionable``, JAX's default since
    0.5): element i of the flattened shape is the XOR of the two words of
    threefry2x32 of the counter pair (i >> 32, i mod 2^32).  An int64
    tensor holding the uint32 values."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=on)
    b0, b1 = threefry2x32(key, idx >> 32, idx & _MASK)
    return (b0 ^ b1).reshape(shape)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel``'s float32 value of 32 random bits (mode
    "low"): the uniform in [tiny, 1) from the top 23 bits (bits >> 9 |
    0x3F800000 is a float in [1, 2); minus 1, scaled onto [tiny, 1)),
    then -log(-log(u))."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    tiny = float(np.finfo(np.float32).tiny)
    span = float(np.float32(1.0) - np.float32(tiny))
    u = torch.clamp_min((one - 1.0) * span + tiny, tiny)
    return -torch.log(-torch.log(u))


def categorical_scores(key: Key, shape, probs, on="cpu") -> torch.Tensor:
    """The (*shape, n_states) float32 scores whose argmax over the last
    axis is ``jax.random.categorical(key, log(probs), shape=shape)``:
    a Gumbel per (element, state) plus the state's log-probability."""
    n = len(probs)
    g = gumbel_from_bits(random_bits(key, (*tuple(shape), n), on))
    return g + torch.log(torch.as_tensor(probs, dtype=torch.float32,
                                         device=on))


def sample_state_offsets_threefry(key: Key, shape, device: DeviceModel,
                                  on="cpu") -> torch.Tensor:
    """Paper-faithful categorical state sampling from the threefry `key`:
    ``jax.random.categorical(key, log(state_probs), shape=shape)`` (the
    first of equal scores wins, as jnp.argmax), looked up in
    ``state_offsets``.  float32, on `on`."""
    state = torch.argmax(categorical_scores(key, shape, device.state_probs,
                                            on), dim=-1)
    table = torch.as_tensor(device.state_offsets, dtype=torch.float32,
                            device=on)
    return table[state]


def noise_factor(offs: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """float32(1 + a * sigma): the multiplicative read factor, rounded as
    the JAX reference rounds it (product, then sum, each in float32)."""
    return 1.0 + offs * sig


def fluctuate(w: torch.Tensor, rho: torch.Tensor, device: DeviceModel,
              cfg: NoiseConfig, *, key: Optional[Key] = None,
              seed=0, plane=0) -> torch.Tensor:
    """The sampled read value w~ = r_l(w, rho) (technique A forward), the
    noise materialized as a weight-sized tensor (the hash backend's is the
    plain version of the fused kernel in kernels/emt_matmul.py).  The
    threefry backend draws from `key` (the key the caller has already
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
