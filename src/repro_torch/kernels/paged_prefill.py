"""Flash-style chunked prefill through the block table: CUDA kernel wrapper
+ plain version.

Replaces ``repro/kernels/paged_prefill.py::paged_prefill_pallas``: a
(B, KV, R, hd) query tile attends table-resolved K/V with causality from
``qpos`` derived in the kernel; blocks past ``qlast[b]`` are skipped.  The
source and its design note: ``csrc/paged_prefill.cu``.

On CPU tensors the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.paged_prefill_ref`); on CUDA tensors it
launches the kernel or raises.  ``paged_prefill.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_prefill_ref


def plain(q, k_pool, v_pool, table, qpos, qlast, *, softcap=0.0):
    """The kernel's plain version (``qlast`` only skips work whose
    contribution is exactly zero, so the plain path ignores it)."""
    del qlast
    return paged_prefill_ref(q, k_pool, v_pool, table, qpos, softcap=softcap)


def _fn():
    fn = _build.library("paged_prefill").paged_prefill_f32
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 7 + [I] * 6 + [F, F, P]
        fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_prefill: {msg}")


def paged_prefill(q, k_pool, v_pool, table, qpos, qlast, *, softcap=0.0):
    """q (B, KV, R, hd) f32; pools (NB + 1, bs, KV, hd) f32; table (B, T)
    int32; qpos (B, R) int32; qlast (B,) int32 = max(qpos[b]).

    Returns (B, KV, R, hd) float32."""
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, table, qpos, qlast, softcap=softcap)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    B, KV, R, hd = q.shape
    bs = k_pool.shape[1]
    T = table.shape[1]
    _require(k_pool.shape == v_pool.shape and k_pool.shape[2:] == (KV, hd),
             f"pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    _require(tuple(qpos.shape) == (B, R), f"qpos {tuple(qpos.shape)}")
    _require(hd <= 256, f"hd={hd} > 256")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and t.device == q.device,
                 f"{name} must be contiguous float32 on {q.device}")
    for name, t in (("table", table), ("qpos", qpos), ("qlast", qlast)):
        _require(t.dtype == torch.int32 and t.is_contiguous()
                 and t.device == q.device,
                 f"{name} must be contiguous int32 on {q.device}")
    out = torch.empty((B, KV, R, hd), dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                table.data_ptr(), qpos.data_ptr(), qlast.data_ptr(),
                out.data_ptr(), B, KV, R, hd, bs, T,
                float(1.0 / np.sqrt(hd)), float(softcap or 0.0),
                torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged_prefill")
    paged_prefill.launches += 1
    return out


paged_prefill.launches = 0
