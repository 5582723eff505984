"""Flash-style chunked prefill through the block table: CUDA kernel wrapper
+ plain version.

Replaces ``repro/kernels/paged_prefill.py::paged_prefill_pallas``: a
(B, KV, R, hd) query tile attends table-resolved K/V with causality from
``qpos`` derived in the kernel; blocks past ``qlast[b]`` are skipped.  The
source and its design note: ``csrc/paged_prefill.cu`` (one warp per query
row, K/V staged by cp.async, the walk split across CTAs by
:func:`kv_splits`).

On CPU tensors the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.paged_prefill_ref`); on CUDA tensors it
launches the kernel or raises.  ``paged_prefill.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, splitk
from repro_torch.kernels.ref import paged_prefill_ref

ROWS_PER_CTA = 4        # csrc/paged_prefill.cu kRT
STAGE_FLOATS = 4096     # csrc kStage: positions per chunk = STAGE / hd, <= 32
MAX_SPLITS = 8          # csrc kMaxSplits: a portable cluster


def plain(q, k_pool, v_pool, table, qpos, qlast, *, softcap=0.0):
    """The kernel's plain version (``qlast`` only skips work whose
    contribution is exactly zero, so the plain path ignores it)."""
    del qlast
    return paged_prefill_ref(q, k_pool, v_pool, table, qpos, softcap=softcap)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.library("paged_prefill").paged_prefill_f32
    if fn.argtypes is None:
        P, F = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [P] * 8 + [F, F, P]
        fn.restype = ctypes.c_int
    return fn


def chunk_positions(hd: int) -> int:
    """K/V positions the kernel stages per step."""
    return min(32, STAGE_FLOATS // hd)


def kv_splits(B: int, KV: int, R: int, T: int, bs: int, hd: int,
              sms: int) -> int:
    """CTAs (one cluster) sharing each row tile's K/V walk: a power of two
    up to MAX_SPLITS, at most one per staged chunk of the view, the largest
    that keeps the grid within about two CTAs per SM."""
    tiles = B * KV * splitk.cdiv(R, ROWS_PER_CTA)
    chunks = splitk.cdiv(T * bs, chunk_positions(hd))
    want = min(chunks, splitk.cdiv(2 * sms, max(1, tiles)), MAX_SPLITS)
    splits = 1
    while splits * 2 <= want:
        splits *= 2
    return splits


@functools.lru_cache(maxsize=1024)
def _launch(B, KV, R, T, bs, hd, sms):
    """(the C entry's int32 dims array, its address) for one call shape;
    the cache keeps the array alive."""
    dims = (ctypes.c_int * 7)(B, KV, R, hd, bs, T,
                              kv_splits(B, KV, R, T, bs, hd, sms))
    return dims, ctypes.addressof(dims)


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_prefill: {msg}")


def paged_prefill(q, k_pool, v_pool, table, qpos, qlast, *, softcap=0.0):
    """q (B, KV, R, hd) f32; pools (NB + 1, bs, KV, hd) f32; table (B, T)
    int32; qpos (B, R) int32; qlast (B,) int32 = max(qpos[b]).

    Returns (B, KV, R, hd) float32."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            return plain(q, k_pool, v_pool, table, qpos, qlast,
                         softcap=softcap)
        _require(False, f"unsupported device {q.device}")
    B, KV, R, hd = q.shape
    bs = k_pool.shape[1]
    T = table.shape[1]
    # (messages are formatted only on failure: this runs 26 times a step)
    if not (k_pool.shape == v_pool.shape and k_pool.shape[2:] == (KV, hd)):
        _require(False, f"pool shapes {tuple(k_pool.shape)} / "
                        f"{tuple(v_pool.shape)}")
    if qpos.shape != (B, R):
        _require(False, f"qpos {tuple(qpos.shape)}")
    _require(hd <= 256, "hd > 256")
    index = q.get_device()
    f32, i32 = torch.float32, torch.int32
    if not (q.dtype is f32 and k_pool.dtype is f32 and v_pool.dtype is f32
            and table.dtype is i32 and qpos.dtype is i32
            and qlast.dtype is i32 and k_pool.get_device() == index
            and v_pool.get_device() == index
            and table.get_device() == index and qpos.get_device() == index
            and qlast.get_device() == index and q.is_contiguous()
            and k_pool.is_contiguous() and v_pool.is_contiguous()
            and table.is_contiguous() and qpos.is_contiguous()
            and qlast.is_contiguous()):
        _require(False, f"inputs must be contiguous and on {q.device}, q "
                        "and the pools float32, table, qpos and qlast int32")
    _, dims = _launch(B, KV, R, T, bs, hd, splitk.sm_count(index))
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                table.data_ptr(), qpos.data_ptr(), qlast.data_ptr(),
                out.data_ptr(), dims, 1.0 / math.sqrt(hd),
                float(softcap or 0.0), _build.stream(index))
    _build.check(err, "paged_prefill")
    paged_prefill.launches += 1
    return out


paged_prefill.launches = 0
