"""Technique-A noisy crossbar matmul: CUDA kernel wrapper + plain version.

Replaces ``repro/kernels/emt_matmul.py::emt_matmul_pallas``: computes
``y = x @ (w * (1 + a_l * sigma))`` with the RTN offsets hashed inside the
weight tile from each element's global (row, col), the runtime step seed and
the layer plane, so no noise tensor reaches device memory.  The source and
its design note: ``csrc/emt_matmul.cu``.

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.emt_matmul_ref`); on a CUDA tensor it launches
the kernel or raises.  ``emt_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import hashrng
from repro_torch.core.device import DeviceModel
from repro_torch.kernels import _build
from repro_torch.kernels.ref import emt_matmul_ref as plain

MAX_STATES = 8


class NoiseParams(ctypes.Structure):
    """Mirror of ``repro::NoiseParams`` in csrc/common.cuh."""
    _fields_ = [("n_states", ctypes.c_int),
                ("thr", ctypes.c_float * (MAX_STATES - 1)),
                ("off", ctypes.c_float * MAX_STATES)]


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
    return p


def _fn():
    fn = _build.library("emt_matmul").emt_matmul_f32
    if fn.argtypes is None:
        P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_uint
        fn.argtypes = [P, P, P, P, I, I, I, LL, LL, LL, LL, U, U, NoiseParams,
                       P]
        fn.restype = ctypes.c_int
    return fn


def emt_matmul(x: torch.Tensor, w: torch.Tensor, sig: torch.Tensor, *,
               device: DeviceModel, seed: int = 0, plane: int = 0):
    """x (M, K) @ noisy(w (K, N)) -> (M, N) float32.

    `w` may have any strides (the tied unembed passes the embedding table's
    transpose without a copy); the noise still hashes the logical
    (row = K index, col = N index).  `sig` is sigma_rel(rho) as a one-element
    float32 tensor on x's device (read by the kernel, no host sync).
    """
    if x.device.type == "cpu":
        return plain(x, w, sig, device=device, seed=seed, plane=plane)
    if x.device.type != "cuda":
        raise ValueError(f"emt_matmul: unsupported device {x.device}")
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"emt_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w), ("sig", sig)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"emt_matmul: {name} must be float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if sig.numel() != 1:
        raise ValueError("emt_matmul: sig must be a scalar tensor")
    sig = sig.reshape(1).contiguous()
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = _fn()(x.data_ptr(), w.data_ptr(), y.data_ptr(), sig.data_ptr(),
                M, N, K, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
                int(seed) & 0xFFFFFFFF, int(plane) & 0xFFFFFFFF,
                noise_params(device), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "emt_matmul")
    emt_matmul.launches += 1
    return y


emt_matmul.launches = 0
