"""Public wrappers around the port's kernels: shape flattening, view
padding, write-slot resolution and query regrouping (port of
:mod:`repro.kernels.ops`).

Dispatch is by the tensors' device: CUDA tensors launch the Hopper kernels,
CPU tensors run the plain versions (there is no per-call implementation
knob and no fallback from CUDA).  The TPU wrappers' VMEM-sized block-chunk
choice (``pick_block_chunk``) does not carry over: the CUDA kernels pick
their own tiles.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.device import DeviceModel
from repro_torch.kernels.emt_bitserial import emt_bitserial as _emt_bitserial
from repro_torch.kernels.emt_matmul import emt_matmul as _emt_matmul
from repro_torch.kernels.emt_matmul import \
    emt_matmul_experts as _emt_matmul_experts
from repro_torch.kernels.paged_attention import \
    paged_attention as _paged_attend
from repro_torch.kernels.paged_attention import \
    paged_attention_decode as _paged_decode
from repro_torch.kernels.paged_prefill import paged_prefill as _paged_prefill
from repro_torch.kernels.ref import NEG_INF


def emt_matmul(x, w, sig, *, device: DeviceModel, seed: int = 0,
               plane: int = 0):
    """Noisy crossbar matmul: x (..., K) @ noisy(w (K, N)) -> (..., N) fp32.
    `w` is float32, or ``(w_int8, w_scale)`` (int8 levels and their
    per-column scale, dequantized in the kernel)."""
    y = _emt_matmul(x.reshape(-1, x.shape[-1]), w, sig, device=device,
                    seed=seed, plane=plane)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def emt_matmul_experts(x, w, sig, *, device: DeviceModel, seed: int = 0,
                       plane: int = 0):
    """A stack of E experts' noisy crossbar matmuls in one call: x (E, M,
    K) @ noisy(w (E, K, N)) -> (y (E, M, N) fp32, sum |w~|, max |w~|), the
    noise of the folded (E * K, N) stack (expert e's rows at e * K + k)."""
    return _emt_matmul_experts(x, w, sig, device=device, seed=seed,
                               plane=plane)


def emt_bitserial_matmul(xq, w, sig, *, device: DeviceModel, bits: int = 7,
                         seed: int = 0, base_plane: int = 0):
    """Bit-serial noisy crossbar matmul (technique C): integer-valued levels
    xq (..., K) against noisy(w (K, N)) one bit-plane at a time -> (..., N)
    fp32."""
    lead = xq.shape[:-1]
    kdim, n = w.shape
    y = _emt_bitserial(xq.reshape(-1, kdim), w, sig, device=device,
                       bits=bits, seed=seed, base_plane=base_plane)
    return y.reshape(*lead, n)


def _view_mask(mask, T: int, bs: int):
    """Pad mask rows with NEG_INF up to the block-rounded view T * bs."""
    L = mask.shape[1]
    if L > T * bs:
        raise ValueError(f"mask rows ({L}) exceed the table view "
                         f"({T}x{bs})")
    mask = mask.to(torch.float32)
    if L < T * bs:
        mask = F.pad(mask, (0, T * bs - L), value=NEG_INF)
    return mask.contiguous()


def paged_attention(q, k_pool, v_pool, table, mask, *, softcap=0.0):
    """One-token attention over read-only paged pools (the enc-dec cross
    attention's decode read).

    q (B, KV, G, hd); pools (NB + 1, bs, KV, hd); table (B, T) int32; mask
    (B, L <= T * bs) additive f32, padded with NEG_INF to the block-rounded
    view.  A row with no visible position gives exact zeros.  Returns
    (B, KV, G, hd) fp32."""
    bs = k_pool.shape[1]
    T = table.shape[1]
    return _paged_attend(q.contiguous(), k_pool, v_pool,
                         table.to(torch.int32).contiguous(),
                         _view_mask(mask, T, bs), softcap=softcap)


def paged_attention_decode(q, k_pool, v_pool, table, mask, k_new, v_new,
                           wpos, active, *, softcap=0.0):
    """One-launch decode: write the step's K/V rows, then attend.

    q (B, KV, G, hd) post-RoPE; pools (NB + 1, bs, KV, hd), updated in
    place; table (B, T) int32; mask (B, L <= T * bs) additive f32; k_new /
    v_new (B, KV, hd); wpos (B,) write positions; active (B,) bool or None
    (all rows write).  Row b writes at ``pool[table[b, wpos // bs],
    wpos % bs]``.  Returns (out (B, KV, G, hd) fp32, k_pool, v_pool)."""
    B = q.shape[0]
    bs = k_pool.shape[1]
    T = table.shape[1]
    mask = _view_mask(mask, T, bs)
    table = table.to(torch.int32).contiguous()
    wpos = torch.as_tensor(wpos, device=q.device).to(torch.int64)
    wblk = torch.gather(table, 1, (wpos // bs)[:, None])[:, 0].contiguous()
    woff = (wpos % bs).to(torch.int32)
    wok = (torch.ones(B, dtype=torch.int32, device=q.device) if active is None
           else active.to(torch.int32))
    out = _paged_decode(
        q.contiguous(), k_pool, v_pool, table, mask,
        k_new.to(k_pool.dtype).contiguous(), v_new.to(v_pool.dtype).contiguous(),
        wblk, woff, wok.contiguous(), softcap=softcap)
    return out, k_pool, v_pool


def paged_prefill(q, k_pool, v_pool, table, qpos, *, softcap=0.0):
    """Chunked prefill attention through the block table.

    q (B, C, H, hd) post-RoPE chunk (its K/V already in the pools); qpos
    (B, C) absolute query positions, padding lanes clamped to the row's
    last real lane.  Returns (B, C, H * hd) fp32."""
    B, C, H, hd = q.shape
    KV = k_pool.shape[2]
    G = H // KV
    # (B, C, H, hd) -> (B, KV, C * G, hd): row c * G + g
    qt = q.reshape(B, C, KV, G, hd).permute(0, 2, 1, 3, 4)
    qt = qt.reshape(B, KV, C * G, hd).contiguous()
    qpe = torch.repeat_interleave(qpos.to(torch.int32), G, dim=1).contiguous()
    qlast = torch.amax(qpe, dim=1).to(torch.int32).contiguous()
    out = _paged_prefill(qt, k_pool, v_pool,
                         table.to(torch.int32).contiguous(), qpe, qlast,
                         softcap=softcap)
    out = out.reshape(B, KV, C, G, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(B, C, H * hd)
