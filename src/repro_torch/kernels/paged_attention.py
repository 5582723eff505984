"""Fused paged-attention decode (K/V write + attend in one launch): CUDA
kernel wrapper + plain version.

Replaces ``repro/kernels/paged_attention.py::paged_attention_decode_pallas``.
The pools are updated **in place**: this replaces the Pallas kernel's
``input_output_aliases``.  Row b writes ``k_new/v_new[b]`` at
``pool[wblk[b], woff[b]]`` iff ``wok[b] != 0`` and then attends its block
table, so it always sees its own write.  The source and its design note:
``csrc/paged_attention.cu``.

On CPU tensors the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.paged_attention_decode_ref`); on CUDA tensors
it launches the kernel or raises.  ``paged_attention_decode.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_decode_ref as plain


def _fn():
    fn = _build.library("paged_attention").paged_decode_f32
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 11 + [I] * 6 + [F, F, P]
        fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_attention_decode: {msg}")


def paged_attention_decode(q, k_pool, v_pool, table, mask, k_new, v_new,
                           wblk, woff, wok, *, softcap=0.0):
    """q (B, KV, G, hd) f32; pools (NB + 1, bs, KV, hd) f32, zero block
    last, updated in place; table (B, T) int32; mask (B, T * bs) f32;
    k_new/v_new (B, KV, hd); wblk/woff/wok (B,) int32.

    Returns (B, KV, G, hd) float32."""
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, table, mask, k_new, v_new, wblk,
                     woff, wok, softcap=softcap)
    _require(q.device.type == "cuda", f"unsupported device {q.device}")
    B, KV, G, hd = q.shape
    bs = k_pool.shape[1]
    T = table.shape[1]
    _require(k_pool.shape == v_pool.shape and k_pool.shape[2:] == (KV, hd),
             f"pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    _require(tuple(mask.shape) == (B, T * bs), f"mask {tuple(mask.shape)}")
    _require(G <= 8 and hd <= 256, f"G={G} > 8 or hd={hd} > 256")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("mask", mask), ("k_new", k_new), ("v_new", v_new)):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and t.device == q.device,
                 f"{name} must be contiguous float32 on {q.device}")
    for name, t in (("table", table), ("wblk", wblk), ("woff", woff),
                    ("wok", wok)):
        _require(t.dtype == torch.int32 and t.is_contiguous()
                 and t.device == q.device,
                 f"{name} must be contiguous int32 on {q.device}")
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                table.data_ptr(), mask.data_ptr(), k_new.data_ptr(),
                v_new.data_ptr(), wblk.data_ptr(), woff.data_ptr(),
                wok.data_ptr(), out.data_ptr(), B, KV, G, hd, bs, T,
                float(1.0 / np.sqrt(hd)), float(softcap or 0.0),
                torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0
