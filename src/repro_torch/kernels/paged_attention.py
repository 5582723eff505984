"""Paged-attention decode: CUDA kernel wrappers + plain versions.

* :func:`paged_attention_decode` (K1), the fused K/V write + attend in one
  launch, replaces ``repro/kernels/paged_attention.py::
  paged_attention_decode_pallas``.  The pools are updated **in place**: this
  replaces the Pallas kernel's ``input_output_aliases``.  Row b writes
  ``k_new/v_new[b]`` at ``pool[wblk[b], woff[b]]`` iff ``wok[b] != 0`` and
  then attends its block table, so it always sees its own write.
* :func:`paged_attention` (K4), the same attend over read-only pools,
  replaces ``repro/kernels/paged_attention.py::paged_attention_pallas``
  (the enc-dec cross attention's decode read).

Both launch one kernel template, ``csrc/paged_attention.cu`` (its design
note is there): each (row, kv head)'s walk over its visible blocks is split
over a thread-block cluster of :func:`kv_splits` CTAs of :func:`threads`
threads.  On CPU tensors a wrapper runs its plain version
(:func:`repro_torch.kernels.ref.paged_attention_decode_ref`, ``plain``;
:func:`repro_torch.kernels.ref.paged_attention_ref`, ``plain_attend``); on
CUDA tensors it launches the kernel or raises.  Each wrapper's
``.launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from repro_torch.kernels import _build, splitk
from repro_torch.kernels.ref import paged_attention_decode_ref as plain
from repro_torch.kernels.ref import paged_attention_ref as plain_attend

MAX_G = 8               # csrc kMaxG
MAX_HD = 256            # csrc kMaxHd
MAX_THREADS = 256       # csrc kMaxThreads
MAX_SPLITS = 8          # csrc kMaxSplits: a portable cluster
# A CTA's threads and the grid's warps an SM, from launches timed on an H100
# 80GB HBM3 at 700 W: a seamless-m4t-medium decode launch (B 4, KV 16, G 1,
# hd 64, 8 blocks) took 13.2 us of device time in clusters of 4 CTAs of 64
# threads, 9.6 us in clusters of 8 of 128; gemma3-1b's (B 4, KV 1, G 4,
# hd 256) 9.4 us in clusters of 8 of 256 (PERF.md).
MIN_THREADS = 128
WARPS_PER_SM = 16


def threads(G: int, hd: int) -> int:
    """Threads a CTA: one per output of the G x hd tile, rounded up to a
    warp, at least MIN_THREADS (the warps stage the K/V chunks and scan the
    mask) and at most MAX_THREADS (then each owns several)."""
    return min(MAX_THREADS, max(MIN_THREADS, splitk.cdiv(G * hd, 32) * 32))


def kv_splits(B: int, KV: int, G: int, hd: int, T: int, sms: int) -> int:
    """CTAs (one cluster) sharing each (row, kv head)'s walk over its T
    blocks: a power of two up to MAX_SPLITS, at most one per block, the
    largest that keeps the grid within WARPS_PER_SM resident warps an SM."""
    ctas = WARPS_PER_SM * sms // (threads(G, hd) // 32)
    want = min(T, ctas // (B * KV), MAX_SPLITS)
    splits = 1
    while splits * 2 <= want:
        splits *= 2
    return splits


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.library("paged_attention"), name)
    if fn.argtypes is None:
        P, F = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [P, P, F, F, P]
        fn.restype = ctypes.c_int
    return fn


_scratch = threading.local()


def _pointers(name: str, n: int):
    """This thread's array of n pointers for the C entry `name`'s `ptrs`
    (filling it costs the host less than converting n ctypes arguments; one
    per thread, as the call releases the GIL)."""
    arr = getattr(_scratch, name, None)
    if arr is None:
        arr = (ctypes.c_void_p * n)()
        setattr(_scratch, name, arr)
    return arr


@functools.lru_cache(maxsize=1024)
def _launch(B, KV, G, hd, bs, T, sms):
    """(the C entry's int32 dims array, its address, the score scale) for
    one call shape; the cache keeps the array alive."""
    dims = (ctypes.c_int * 8)(B, KV, G, hd, bs, T,
                              kv_splits(B, KV, G, hd, T, sms), threads(G, hd))
    return dims, ctypes.addressof(dims), 1.0 / math.sqrt(hd)


def _require(cond: bool, msg: str, what: str = "paged_attention_decode"):
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_attend(q, k_pool, v_pool, table, mask, what):
    """The shape, type and layout checks shared by both kernels (five shape
    reads; messages formatted only on failure: K1 runs 26 times a step).
    Returns the device index and the launch's (dims array, address,
    scale)."""
    B, KV, G, hd = q.shape
    ks = k_pool.shape
    T = table.shape[1]
    if not (ks == v_pool.shape and ks[2] == KV and ks[3] == hd
            and mask.shape == (B, T * ks[1]) and G <= MAX_G
            and hd <= MAX_HD):
        _require(False, f"q {tuple(q.shape)}, pools {tuple(ks)} / "
                        f"{tuple(v_pool.shape)}, mask {tuple(mask.shape)} "
                        f"(G <= {MAX_G}, hd <= {MAX_HD})", what)
    index = q.get_device()
    f32 = torch.float32
    if not (q.dtype is f32 and k_pool.dtype is f32 and v_pool.dtype is f32
            and mask.dtype is f32 and table.dtype is torch.int32
            and k_pool.get_device() == index
            and v_pool.get_device() == index and mask.get_device() == index
            and table.get_device() == index and q.is_contiguous()
            and k_pool.is_contiguous() and v_pool.is_contiguous()
            and mask.is_contiguous() and table.is_contiguous()):
        _require(False, f"inputs must be contiguous and on {q.device}, q, "
                        "the pools and mask float32, table int32", what)
    return index, _launch(B, KV, G, hd, ks[1], T, splitk.sm_count(index))


def paged_attention_decode(q, k_pool, v_pool, table, mask, k_new, v_new,
                           wblk, woff, wok, *, softcap=0.0):
    """q (B, KV, G, hd) f32; pools (NB + 1, bs, KV, hd) f32, zero block
    last, updated in place; table (B, T) int32; mask (B, T * bs) f32;
    k_new/v_new (B, KV, hd); wblk/woff/wok (B,) int32.

    Returns (B, KV, G, hd) float32."""
    if not q.is_cuda:
        _require(q.device.type == "cpu", f"unsupported device {q.device}")
        return plain(q, k_pool, v_pool, table, mask, k_new, v_new, wblk,
                     woff, wok, softcap=softcap)
    index, (_, dims, scale) = _check_attend(q, k_pool, v_pool, table, mask,
                                            "paged_attention_decode")
    if not (k_new.dtype is torch.float32 and v_new.dtype is torch.float32
            and k_new.get_device() == index and v_new.get_device() == index
            and k_new.is_contiguous() and v_new.is_contiguous()
            and wblk.dtype is torch.int32 and woff.dtype is torch.int32
            and wok.dtype is torch.int32 and wblk.get_device() == index
            and woff.get_device() == index and wok.get_device() == index
            and wblk.is_contiguous() and woff.is_contiguous()
            and wok.is_contiguous()):
        _require(False, f"k_new/v_new must be contiguous float32 and "
                        f"wblk/woff/wok contiguous int32, on {q.device}")
    out = torch.empty_like(q)
    ptrs = _pointers("decode", 11)
    ptrs[:] = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
               table.data_ptr(), mask.data_ptr(), k_new.data_ptr(),
               v_new.data_ptr(), wblk.data_ptr(), woff.data_ptr(),
               wok.data_ptr(), out.data_ptr())
    err = _fn("paged_decode_f32")(ptrs, dims, scale, float(softcap or 0.0),
                                  _build.stream(index))
    _build.check(err, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def paged_attention(q, k_pool, v_pool, table, mask, *, softcap=0.0):
    """q (B, KV, G, hd) f32; pools (NB + 1, bs, KV, hd) f32, zero block
    last, only read; table (B, T) int32; mask (B, T * bs) f32 additive (a
    row with no visible position gives exact zeros).

    Returns (B, KV, G, hd) float32."""
    if not q.is_cuda:
        _require(q.device.type == "cpu", f"unsupported device {q.device}",
                 "paged_attention")
        return plain_attend(q, k_pool, v_pool, table, mask, softcap=softcap)
    index, (_, dims, scale) = _check_attend(q, k_pool, v_pool, table, mask,
                                            "paged_attention")
    out = torch.empty_like(q)
    ptrs = _pointers("attend", 6)
    ptrs[:] = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
               table.data_ptr(), mask.data_ptr(), out.data_ptr())
    err = _fn("paged_attend_f32")(ptrs, dims, scale, float(softcap or 0.0),
                                  _build.stream(index))
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
