"""Technique-A noisy crossbar matmul: CUDA kernel wrapper + plain version.

Replaces ``repro/kernels/emt_matmul.py::emt_matmul_pallas``: computes
``y = x @ (w * (1 + a_l * sigma))`` with the RTN offsets hashed inside the
weight tile from each element's global (row, col), the runtime step seed and
the layer plane, so no noise tensor reaches device memory.  The source and
its design note: ``csrc/emt_matmul.cu`` (a GEMV-style kernel for M <= 16,
a tiled one above; both split K by :func:`plan`).

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.emt_matmul_ref`); on a CUDA tensor it launches
the kernel or raises.  ``emt_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import hashrng
from repro_torch.core.device import DeviceModel
from repro_torch.kernels import _build, splitk
from repro_torch.kernels.ref import emt_matmul_ref as plain

MAX_STATES = 8
# csrc/emt_matmul.cu: the GEMV kernel takes M <= GEMV_MAX_M rows (templated
# on 1-4, 8 and 16); its CTA covers 128 columns of an n-major weight (slabs
# in multiples of 32 rows), or 32 columns of any other weight (multiples of
# 128), and stages its slab's x rows, at most GEMV_X_BYTES, in shared
# memory; the tiled kernel covers 64 x 64 outputs in 32-row K tiles.
GEMV_MAX_M = 16
GEMV_X_BYTES = 24 * 1024
GEMV_N = dict(bn=128, bk=32, min_slab=64)
GEMV_K = dict(bn=32, bk=128, min_slab=256)
TILED = dict(bm=64, bn=64, bk=32, min_slab=64)


class NoiseParams(ctypes.Structure):
    """Mirror of ``repro::NoiseParams`` in csrc/common.cuh."""
    _fields_ = [("n_states", ctypes.c_int),
                ("thr", ctypes.c_float * (MAX_STATES - 1)),
                ("off", ctypes.c_float * MAX_STATES),
                ("t2", ctypes.c_uint32)]


def _uniform(bits: int) -> float:
    """The uniform a hash draw `bits` gives: fl32(bits) * 2^-32, as the
    kernels and hashrng round it (one rounding of the exact integer)."""
    return float(np.float32(bits)) * 2.0 ** -32


def int_threshold(thr: float) -> int:
    """The least uint32 `bits` with _uniform(bits) >= thr (that is
    monotonic in bits, so u >= thr iff bits >= this).  The kernels' two-state
    lookup compares the hash bits with it: one integer compare, no
    conversion."""
    lo, hi = 0, 2 ** 32
    while lo < hi:
        mid = (lo + hi) // 2
        if _uniform(mid) >= thr:
            hi = mid
        else:
            lo = mid + 1
    if lo == 2 ** 32:
        raise ValueError(f"state threshold {thr} above every uniform")
    return lo


def noise_params(device: DeviceModel) -> NoiseParams:
    """The RTN state table as the kernel compares it (float32 thresholds
    and offsets, computed exactly as hashrng does), built once per table."""
    return _noise_params(device.state_offsets, device.state_probs)


@functools.lru_cache(maxsize=None)
def _noise_params(offsets: tuple, probs: tuple) -> NoiseParams:
    n = len(offsets)
    if n > MAX_STATES:
        raise ValueError(f"{n} RTN states exceed the kernel's {MAX_STATES}")
    p = NoiseParams()
    p.n_states = n
    for i, t in enumerate(hashrng.state_thresholds(probs)):
        p.thr[i] = t
    for i, o in enumerate(hashrng.state_offset_table(offsets)):
        p.off[i] = o
    if n == 2:
        p.t2 = int_threshold(p.thr[0])
    return p


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("emt_matmul").emt_matmul_f32
    if fn.argtypes is None:
        P, U = ctypes.c_void_p, ctypes.c_uint
        fn.argtypes = [P, P, P, P, P, P, U, U, P, P]
        fn.restype = ctypes.c_int
    return fn


def plan(M: int, N: int, K: int, sms: int, n_major: bool) -> splitk.Plan:
    """The kernel's cut of (M, K) @ (K, N): K split until the grid holds two
    CTAs per SM (what ~128 registers per thread allow), in whole chunks or
    tiles.  `n_major`: the weight's N stride is 1."""
    if M <= GEMV_MAX_M:
        kw = GEMV_N if n_major else GEMV_K
        rows = M if M <= 4 else 8 if M <= 8 else 16      # the row template
        max_slab = GEMV_X_BYTES // (4 * rows) // kw["bk"] * kw["bk"]
        return splitk.plan(M, N, K, bm=M, sms=sms, max_slab=max_slab, **kw)
    return splitk.plan(M, N, K, sms=sms, **TILED)


@functools.lru_cache(maxsize=4096)
def _launch(index, M, N, K, sxm, sxk, swk, swn):
    """(plan, the C entry's int64 dims array, its address) for one call
    shape on device `index`; the cache keeps the array alive."""
    p = plan(M, N, K, splitk.sm_count(index), swn == 1)
    dims = (ctypes.c_longlong * 9)(M, N, K, p.splits, p.k_slab, sxm, sxk,
                                   swk, swn)
    return p, dims, ctypes.addressof(dims)


def emt_matmul(x: torch.Tensor, w: torch.Tensor, sig: torch.Tensor, *,
               device: DeviceModel, seed: int = 0, plane: int = 0):
    """x (M, K) @ noisy(w (K, N)) -> (M, N) float32.

    `w` may have any strides (the tied unembed passes the embedding table's
    transpose without a copy); the noise still hashes the logical
    (row = K index, col = N index).  `sig` is sigma_rel(rho) as a one-element
    float32 tensor on x's device (read by the kernel, no host sync).
    """
    if not x.is_cuda:
        if x.device.type == "cpu":
            return plain(x, w, sig, device=device, seed=seed, plane=plane)
        raise ValueError(f"emt_matmul: unsupported device {x.device}")
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"emt_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    index = x.get_device()
    f32 = torch.float32
    if not (x.dtype is f32 and w.dtype is f32 and sig.dtype is f32
            and w.get_device() == index and sig.get_device() == index):
        raise ValueError(f"emt_matmul: x, w and sig must be float32 on "
                         f"{x.device}, got {x.dtype}, {w.dtype}, {sig.dtype} "
                         f"on {x.device}, {w.device}, {sig.device}")
    if sig.numel() != 1:
        raise ValueError("emt_matmul: sig must be a scalar tensor")
    p, _, dims = _launch(index, M, N, K, *x.stride(), *w.stride())
    y, part = splitk.outputs(p, x)
    err = _fn()(x.data_ptr(), w.data_ptr(), y.data_ptr(), part,
                sig.data_ptr(), dims, int(seed) & 0xFFFFFFFF,
                int(plane) & 0xFFFFFFFF,
                ctypes.addressof(noise_params(device)),
                _build.stream(index))
    _build.check(err, "emt_matmul")
    emt_matmul.launches += 1
    return y


emt_matmul.launches = 0
