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
note is there).  On CPU tensors a wrapper runs its plain version
(:func:`repro_torch.kernels.ref.paged_attention_decode_ref`, ``plain``;
:func:`repro_torch.kernels.ref.paged_attention_ref`, ``plain_attend``); on
CUDA tensors it launches the kernel or raises.  Each wrapper's
``.launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_decode_ref as plain
from repro_torch.kernels.ref import paged_attention_ref as plain_attend


def _fn(name: str, pointers: int):
    fn = getattr(_build.library("paged_attention"), name)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * pointers + [I] * 6 + [F, F, P]
        fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str, what: str = "paged_attention_decode"):
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_attend(q, k_pool, v_pool, table, mask, what):
    """The shape, type and layout checks shared by both kernels."""
    _require(q.device.type == "cuda", f"unsupported device {q.device}", what)
    B, KV, G, hd = q.shape
    bs = k_pool.shape[1]
    T = table.shape[1]
    _require(k_pool.shape == v_pool.shape and k_pool.shape[2:] == (KV, hd),
             f"pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)}",
             what)
    _require(tuple(mask.shape) == (B, T * bs), f"mask {tuple(mask.shape)}",
             what)
    _require(G <= 8 and hd <= 256, f"G={G} > 8 or hd={hd} > 256", what)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("mask", mask)):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and t.device == q.device,
                 f"{name} must be contiguous float32 on {q.device}", what)
    _require(table.dtype == torch.int32 and table.is_contiguous()
             and table.device == q.device,
             f"table must be contiguous int32 on {q.device}", what)
    return B, KV, G, hd, bs, T


def paged_attention_decode(q, k_pool, v_pool, table, mask, k_new, v_new,
                           wblk, woff, wok, *, softcap=0.0):
    """q (B, KV, G, hd) f32; pools (NB + 1, bs, KV, hd) f32, zero block
    last, updated in place; table (B, T) int32; mask (B, T * bs) f32;
    k_new/v_new (B, KV, hd); wblk/woff/wok (B,) int32.

    Returns (B, KV, G, hd) float32."""
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, table, mask, k_new, v_new, wblk,
                     woff, wok, softcap=softcap)
    B, KV, G, hd, bs, T = _check_attend(q, k_pool, v_pool, table, mask,
                                        "paged_attention_decode")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and t.device == q.device,
                 f"{name} must be contiguous float32 on {q.device}")
    for name, t in (("wblk", wblk), ("woff", woff), ("wok", wok)):
        _require(t.dtype == torch.int32 and t.is_contiguous()
                 and t.device == q.device,
                 f"{name} must be contiguous int32 on {q.device}")
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    err = _fn("paged_decode_f32", 11)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        mask.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), wblk.data_ptr(),
        woff.data_ptr(), wok.data_ptr(), out.data_ptr(), B, KV, G, hd, bs, T,
        float(1.0 / np.sqrt(hd)), float(softcap or 0.0),
        _build.stream(q.get_device()))
    _build.check(err, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def paged_attention(q, k_pool, v_pool, table, mask, *, softcap=0.0):
    """q (B, KV, G, hd) f32; pools (NB + 1, bs, KV, hd) f32, zero block
    last, only read; table (B, T) int32; mask (B, T * bs) f32 additive (a
    row with no visible position gives exact zeros).

    Returns (B, KV, G, hd) float32."""
    if q.device.type == "cpu":
        return plain_attend(q, k_pool, v_pool, table, mask, softcap=softcap)
    B, KV, G, hd, bs, T = _check_attend(q, k_pool, v_pool, table, mask,
                                        "paged_attention")
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    err = _fn("paged_attend_f32", 6)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        mask.data_ptr(), out.data_ptr(), B, KV, G, hd, bs, T,
        float(1.0 / np.sqrt(hd)), float(softcap or 0.0),
        _build.stream(q.get_device()))
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
