"""Technique-C bit-serial noisy crossbar matmul: CUDA kernel wrapper + plain
version.

Replaces ``repro/kernels/emt_bitserial.py::emt_bitserial_pallas``: for each
plane p < bits, ``2^p * (sign(xq) * bit_p(|xq|)) @ (w * (1 + a_p * sigma))``
with fresh hash noise on plane ``base_plane + p``, summed over the planes.
The step seed is a run-time argument (the JAX Pallas wrapper's
``seed_static=0`` under jit is not copied: the kernel follows the path JAX
serves on, ``decompose.bitserial_matmul_ref``).  The source and its design
note: ``csrc/emt_bitserial.cu`` (a GEMV-style kernel for M <= 16, a tiled
one above; both split K by :func:`plan`).

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.emt_bitserial_ref`); on a CUDA tensor it
launches the kernel or raises.  ``emt_bitserial.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.device import DeviceModel
from repro_torch.kernels import _build, splitk
from repro_torch.kernels.emt_matmul import noise_params
from repro_torch.kernels.ref import emt_bitserial_ref as plain

MAX_BITS = 24           # levels up to 2^24 are exact float32 integers
# csrc/emt_bitserial.cu: the GEMV kernel takes M <= GEMV_MAX_M rows
# (templated on 1-4, 8 and 16); its CTA covers 128 columns of an n-major
# weight, or 32 columns of any other, over slabs of whole 32-row bands, and
# stages its slab's signed planes (4 * rows * bits * k_slab bytes), at most
# GEMV_X_BYTES; the tiled kernel covers 64 x 64 outputs in 32-row K tiles.
GEMV_MAX_M = 16
GEMV_X_BYTES = 96 * 1024
GEMV_N = dict(bn=128, bk=32, min_slab=64)
GEMV_K = dict(bn=32, bk=32, min_slab=64)
# CTAs of 256 threads a GEMV grid aims at per SM, by row template.  The hash
# chains need resident warps to hide their latency: on an H100 80GB HBM3 at
# 700 W a gemma3-1b decode step's 78 calls at M = 4 ran faster at each step
# from 2 to 4 to 5 CTAs an SM (5.75 -> 5.47 ms of device time from 4 to 5;
# PERF.md), though ptxas gives that template 54 registers, so an SM holds
# 4 at once and the last fifth of the grid runs as a second wave.  M = 1-3
# take M = 4's value, carried over, not measured (no main path runs them).
# M = 8 and 16 (75 and 111 registers) aim at what an SM holds: 3 and 2.
GEMV_CTAS_PER_SM = {1: 5, 2: 5, 3: 5, 4: 5, 8: 3, 16: 2}
TILED = dict(bm=64, bn=64, bk=32, min_slab=256)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("emt_bitserial").emt_bitserial_f32
    if fn.argtypes is None:
        P, U = ctypes.c_void_p, ctypes.c_uint
        fn.argtypes = [P, P, P, P, P, P, U, U, P, P]
        fn.restype = ctypes.c_int
    return fn


def gemv_rows(M: int) -> int:
    """The GEMV row template that serves M rows."""
    return M if M <= 4 else 8 if M <= 8 else 16


def plan(M: int, N: int, K: int, sms: int, n_major: bool = True,
         bits: int = 7) -> splitk.Plan:
    """The kernel's cut of (M, K) @ (K, N) with `bits` planes: K split until
    the grid holds the CTAs an SM holds at once (GEMV, M <= 16:
    GEMV_CTAS_PER_SM, in whole 32-row bands, with the slab's staged planes
    within GEMV_X_BYTES; tiled: two, what ~128 registers per thread allow,
    in 32-row tiles with at least 256 rows a slab).  `n_major`: the
    weight's N stride is 1."""
    if M <= GEMV_MAX_M:
        kw = GEMV_N if n_major else GEMV_K
        rows = gemv_rows(M)
        max_slab = GEMV_X_BYTES // (4 * rows * bits) // kw["bk"] * kw["bk"]
        return splitk.plan(M, N, K, bm=M, sms=sms, max_slab=max_slab,
                           per_sm=GEMV_CTAS_PER_SM[rows], **kw)
    return splitk.plan(M, N, K, sms=sms, **TILED)


@functools.lru_cache(maxsize=4096)
def _launch(index, M, N, K, sxm, sxk, swk, swn, bits):
    """(plan, the C entry's int64 dims array, its address) for one call
    shape on device `index`; the cache keeps the array alive."""
    p = plan(M, N, K, splitk.sm_count(index), swn == 1, bits)
    dims = (ctypes.c_longlong * 10)(M, N, K, p.splits, p.k_slab, sxm, sxk,
                                    swk, swn, bits)
    return p, dims, ctypes.addressof(dims)


def emt_bitserial(xq: torch.Tensor, w: torch.Tensor, sig: torch.Tensor, *,
                  device: DeviceModel, bits: int = 7, seed: int = 0,
                  base_plane: int = 0):
    """xq (M, K) integer-valued float levels, w (K, N) -> (M, N) float32.

    `w` may have any strides.  `sig` is sigma_rel(rho) as a one-element
    float32 tensor on xq's device (read by the kernel, no host sync);
    `seed` the step's noise seed."""
    if not xq.is_cuda:
        if xq.device.type == "cpu":
            return plain(xq, w, sig, device=device, bits=bits, seed=seed,
                         base_plane=base_plane)
        raise ValueError(f"emt_bitserial: unsupported device {xq.device}")
    M, K = xq.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"emt_bitserial: shapes {tuple(xq.shape)} @ "
                         f"{tuple(w.shape)}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"emt_bitserial: bits {bits} not in "
                         f"[1, {MAX_BITS}]")
    index = xq.get_device()
    f32 = torch.float32
    if not (xq.dtype is f32 and w.dtype is f32 and sig.dtype is f32
            and w.get_device() == index and sig.get_device() == index):
        raise ValueError(f"emt_bitserial: xq, w and sig must be float32 on "
                         f"{xq.device}, got {xq.dtype}, {w.dtype}, "
                         f"{sig.dtype} on {xq.device}, {w.device}, "
                         f"{sig.device}")
    if sig.numel() != 1:
        raise ValueError("emt_bitserial: sig must be a scalar tensor")
    p, _, dims = _launch(index, M, N, K, *xq.stride(), *w.stride(), bits)
    y, part = splitk.outputs(p, xq)
    err = _fn()(xq.data_ptr(), w.data_ptr(), y.data_ptr(), part,
                sig.data_ptr(), dims, int(seed) & 0xFFFFFFFF,
                int(base_plane) & 0xFFFFFFFF,
                ctypes.addressof(noise_params(device)), _build.stream(index))
    _build.check(err, "emt_bitserial")
    emt_bitserial.launches += 1
    return y


emt_bitserial.launches = 0
