"""Counter-based hash RNG, bit-exact with :mod:`repro.core.hashrng`.

Noise is a pure function of ``(seed, plane, global_row, global_col)``: two
rounds of the murmur3/lowbias32 finalizer over a Weyl-sequence counter.  The
CUDA kernels (``kernels/csrc/common.cuh``) evaluate the same function per
weight element inside its tile, so the kernel and this reference agree bit
for bit.

torch on the CPU has no ``>>`` for ``uint32``, so the arithmetic runs in
int64 holding values in ``[0, 2**32)``.  Every 32x32-bit multiply is split
into two 16-bit halves so no intermediate exceeds 2**49 (no signed
overflow), and the result is masked back to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_C1 = 0x9E3779B9
_C2 = 0x85EBCA6B
_C3 = 0xC2B2AE35
_M1 = 0x7FEB352D
_M2 = 0x846CA68B


def _u32(x) -> torch.Tensor:
    """int64 tensor holding the uint32 bit pattern of `x`."""
    x = torch.as_tensor(x)
    if x.dtype == torch.uint32:
        x = x.to(torch.int64)
    return x.to(torch.int64) & _MASK


def _mul(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant m."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _finalize(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul(x, _M1)
    x = x ^ (x >> 15)
    x = _mul(x, _M2)
    x = x ^ (x >> 16)
    return x


def hash_counters(seed, row, col, plane=0) -> torch.Tensor:
    """Hash integer counters into uniform 32-bit values (int64 holding the
    uint32 pattern).  `row`/`col` broadcast; `seed`/`plane` are scalars or
    broadcastable tensors."""
    row, col = _u32(row), _u32(col)
    seed = _u32(seed).to(row.device)
    plane = _u32(plane).to(row.device)
    h = _mul(row, _C1) ^ _mul(col, _C2)
    h = h ^ _mul(plane, _C3) ^ seed
    h = _finalize(h)
    return _finalize(h ^ 0x68E31DA4)


def tile_uniform_bits(seed, row0, col0, shape, plane=0, *,
                      device="cpu") -> torch.Tensor:
    """Uniform bits for a (rows, cols) tile whose global origin is
    (row0, col0)."""
    rows = (torch.arange(shape[0], dtype=torch.int64, device=device)
            + int(row0))[:, None]
    cols = (torch.arange(shape[1], dtype=torch.int64, device=device)
            + int(col0))[None, :]
    return hash_counters(seed, rows & _MASK, cols & _MASK, plane)


def state_thresholds(probs) -> tuple:
    """Cumulative state thresholds as the JAX reference compares them: summed
    in Python double, then rounded once to float32 (weak-typed literal)."""
    out, cum = [], 0.0
    for p in probs[:-1]:
        cum += p
        out.append(float(np.float32(cum)))
    return tuple(out)


def bits_to_state(bits: torch.Tensor, probs) -> torch.Tensor:
    """Uniform bits -> categorical state index (int32)."""
    # uint32 -> float32 rounds to nearest; the 2**-32 scale is exact
    u = bits.to(torch.float32) * (1.0 / 4294967296.0)
    state = torch.zeros(bits.shape, dtype=torch.int32, device=bits.device)
    for i, cum in enumerate(state_thresholds(probs)):
        state = torch.where(u >= cum, torch.full_like(state, i + 1), state)
    return state


def state_offset_from_bits(bits: torch.Tensor, offsets, probs) -> torch.Tensor:
    """Uniform bits -> normalized RTN state offset a_l (float32)."""
    state = bits_to_state(bits, probs)
    out = torch.full(bits.shape, float(offsets[0]), dtype=torch.float32,
                     device=bits.device)
    for i in range(1, len(offsets)):
        out = torch.where(state == i,
                          torch.full_like(out, float(offsets[i])), out)
    return out


def state_offset_table(offsets) -> tuple:
    """The offsets as the float32 values the select chain produces."""
    return tuple(float(np.float32(o)) for o in offsets)


def tile_state_offsets(seed, row0, col0, shape, offsets, probs, plane=0, *,
                       device="cpu") -> torch.Tensor:
    """Tile coordinates -> RTN normalized offsets (float32)."""
    return state_offset_from_bits(
        tile_uniform_bits(seed, row0, col0, shape, plane, device=device),
        offsets, probs)
