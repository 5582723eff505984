"""Technique-C bit-serial noisy crossbar matmul: CUDA kernel wrapper + plain
version.

Replaces ``repro/kernels/emt_bitserial.py::emt_bitserial_pallas``: for each
plane p < bits, ``2^p * (sign(xq) * bit_p(|xq|)) @ (w * (1 + a_p * sigma))``
with fresh hash noise on plane ``base_plane + p``, summed over the planes.
The step seed is a run-time argument (the JAX Pallas wrapper's
``seed_static=0`` under jit is not copied: the kernel follows the path JAX
serves on, ``decompose.bitserial_matmul_ref``).  The source and its design
note: ``csrc/emt_bitserial.cu``.

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
from repro_torch.kernels.emt_matmul import NoiseParams, noise_params
from repro_torch.kernels.ref import emt_bitserial_ref as plain

BN, BK = 64, 32         # output columns per CTA, K-tile (csrc kBN, kBK)
MAX_BITS = 24           # levels up to 2^24 are exact float32 integers


def _fn():
    fn = _build.library("emt_bitserial").emt_bitserial_f32
    if fn.argtypes is None:
        P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_uint
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, LL, LL, LL, LL, I, U,
                       U, NoiseParams, P]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int, sms: int) -> splitk.Plan:
    """Split K until every SM holds two CTAs (what ~122 registers per
    thread allow) when the output tiles alone do not, with at least 256 of
    K per slab."""
    return splitk.plan(M, N, K, bm=16 if M <= 16 else 64, bn=BN, bk=BK,
                       sms=sms, min_slab=256)


def emt_bitserial(xq: torch.Tensor, w: torch.Tensor, sig: torch.Tensor, *,
                  device: DeviceModel, bits: int = 7, seed: int = 0,
                  base_plane: int = 0):
    """xq (M, K) integer-valued float levels, w (K, N) -> (M, N) float32.

    `sig` is sigma_rel(rho) as a one-element float32 tensor on xq's device
    (read by the kernel, no host sync); `seed` the step's noise seed."""
    if xq.device.type == "cpu":
        return plain(xq, w, sig, device=device, bits=bits, seed=seed,
                     base_plane=base_plane)
    if xq.device.type != "cuda":
        raise ValueError(f"emt_bitserial: unsupported device {xq.device}")
    M, K = xq.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"emt_bitserial: shapes {tuple(xq.shape)} @ "
                         f"{tuple(w.shape)}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"emt_bitserial: bits {bits} not in "
                         f"[1, {MAX_BITS}]")
    for name, t in (("xq", xq), ("w", w), ("sig", sig)):
        if t.dtype != torch.float32 or t.device != xq.device:
            raise ValueError(f"emt_bitserial: {name} must be float32 on "
                             f"{xq.device}, got {t.dtype} on {t.device}")
    if sig.numel() != 1:
        raise ValueError("emt_bitserial: sig must be a scalar tensor")
    sig = sig.reshape(1).contiguous()
    p = plan(M, N, K, splitk.sm_count(xq.device.index))
    y, part = splitk.outputs(p, xq)
    err = _fn()(xq.data_ptr(), w.data_ptr(), y.data_ptr(), part,
                sig.data_ptr(), M, N, K, p.splits, p.k_slab, xq.stride(0),
                xq.stride(1), w.stride(0), w.stride(1), int(bits),
                int(seed) & 0xFFFFFFFF,
                int(base_plane) & 0xFFFFFFFF, noise_params(device),
                _build.stream(xq.get_device()))
    _build.check(err, "emt_bitserial")
    emt_bitserial.launches += 1
    return y


emt_bitserial.launches = 0
