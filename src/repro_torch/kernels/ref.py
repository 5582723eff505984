"""Plain PyTorch versions of the Hopper kernels (port of
:mod:`repro.kernels.ref`).

Each function computes exactly what its kernel computes, with one-shot
(not online) softmax for the attention kernels, so the pair agrees to
float32 accumulation order.  The kernel wrappers take these for tensors on
the CPU; the tests hold them against the JAX oracles and interpret-mode
Pallas kernels, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashrng
from repro_torch.core.decompose import bitserial_fwd
from repro_torch.core.device import DeviceModel
from repro_torch.core.noise import noise_factor

# The additive-mask sentinel; must equal models.common.NEG_INF.
NEG_INF = -1e30


def _noise(w, sig, device: DeviceModel, seed, plane):
    """(a, f): the RTN offsets hashed at every weight element's global
    (row, col) and the read factor fl(1 + a * sig), weight-shaped."""
    kdim, n = w.shape
    offs = hashrng.tile_state_offsets(seed, 0, 0, (kdim, n),
                                      device.state_offsets,
                                      device.state_probs, plane,
                                      device=w.device)
    return offs, noise_factor(offs, sig)


def dequantize(w_int8, w_scale):
    """The float32 weight of int8 levels and their per-column scale:
    fl(float(q) * scale), as the reference's w_int8.astype(f32) *
    w_scale."""
    return w_int8.to(torch.float32) * w_scale.reshape(1, -1).to(torch.float32)


def emt_matmul_ref(x, w, sig, *, device: DeviceModel, seed=0, plane=0):
    """x (M, K) @ (w * (1 + a * sig)) with the RTN offsets a hashed from
    the global (row, col) of every weight element.  `w` may be int8 levels
    and their scale, ``(w_int8, w_scale)``: dequantized first.  Returns
    (M, N) fp32."""
    if isinstance(w, tuple):
        w = dequantize(*w)
    _, f = _noise(w, sig, device, seed, plane)
    wn = (w.to(torch.float32) * f).to(w.dtype)
    return torch.matmul(x, wn).to(torch.float32)


def emt_matmul_dx_ref(g, w, sig, *, device: DeviceModel, seed=0, plane=0):
    """The input gradient of emt_matmul_ref for the cotangent g (M, N):
    g @ (w * f)^T through the materialized factor.  Returns (M, K) in g's
    dtype (float64 in, float64 out)."""
    _, f = _noise(w, sig, device, seed, plane)
    return torch.matmul(g, (w * f).to(g.dtype).T)


def emt_matmul_dw_ref(x, g, w, sig, *, device: DeviceModel, seed=0,
                      plane=0):
    """(dw, dsig) of emt_matmul_ref for the cotangent g: with gw = x^T g,
    dw = gw * f and dsig = sum (gw * w) * a, the rounding of XLA's VJP of
    ``w * (1 + a * sig)``."""
    offs, f = _noise(w, sig, device, seed, plane)
    gw = torch.matmul(x.T, g)
    return gw * f, torch.sum((gw * w) * offs)


def emt_bitserial_ref(xq, w, sig, *, device: DeviceModel, bits=7, seed=0,
                      base_plane=0):
    """Technique C: for each plane p < bits, 2^p (sign(xq) delta_p(|xq|)) @
    (w * (1 + a_p * sig)) with fresh hash noise on plane base_plane + p,
    summed per plane.  xq (M, K) integer-valued float levels.  Returns
    (M, N) fp32."""
    return bitserial_fwd(xq, w, sig, device, bits, seed=seed,
                         base_plane=base_plane)


def _bmm_masked_attend(q, kv, vv, mask_rows, *, softcap=0.0):
    """One-shot masked softmax attend.  q (B, KV, R, hd); kv/vv
    (B, L, KV, hd); mask_rows (B, R|1, L) additive fp32.  Masked lanes give
    exact zeros and a row with no visible lane gives zeros (m_safe guard).
    K/V at masked lanes are assumed finite: p = 0 still multiplies a masked
    lane's V row, so a NaN or Inf there gives NaN, as in the TPU kernel,
    while the CUDA decode kernels skip fully masked blocks and return NaN
    only when such a lane shares a block with a visible one.
    Returns (B, KV, R, hd) fp32."""
    B, KV, R, hd = q.shape
    L = kv.shape[1]
    scale = 1.0 / np.sqrt(hd)
    k2 = kv.permute(0, 2, 1, 3).reshape(B * KV, L, hd)
    v2 = vv.permute(0, 2, 1, 3).reshape(B * KV, L, hd)
    q2 = q.reshape(B * KV, R, hd)
    s = torch.bmm(q2, k2.to(q2.dtype).transpose(1, 2)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask3 = mask_rows.expand(B, mask_rows.shape[1], L)
    s = s + torch.repeat_interleave(mask3, KV, dim=0)
    m = torch.amax(s, dim=-1, keepdim=True)
    m_safe = torch.where(m > NEG_INF / 2, m, torch.zeros_like(m))
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m_safe),
                    torch.zeros_like(s))
    acc = torch.bmm(p.to(v2.dtype), v2)
    out = acc / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    return out.reshape(B, KV, R, hd)


def paged_view(pool, table):
    """(B, T * bs, KV, hd) logical view gathered through the block table."""
    B, T = table.shape
    bs = pool.shape[1]
    return pool[table.long()].reshape(B, T * bs, *pool.shape[2:])


def paged_attention_ref(q, k_pool, v_pool, table, mask, *, softcap=0.0):
    """One-token GQA attention over the table-gathered view.  q
    (B, KV, G, hd); pools (NB + 1, bs, KV, hd); table (B, T); mask
    (B, T * bs).  Returns (B, KV, G, hd) fp32."""
    return _bmm_masked_attend(q, paged_view(k_pool, table),
                              paged_view(v_pool, table), mask[:, None, :],
                              softcap=softcap)


def paged_write_rows(pool, rows, wblk, woff, wok):
    """pool[wblk[b], woff[b]] = rows[b] where wok[b] != 0, in place."""
    sel = torch.nonzero(wok != 0).flatten()
    if sel.numel():
        pool.index_put_((wblk[sel].long(), woff[sel].long()),
                        rows[sel].to(pool.dtype))


def paged_attention_decode_ref(q, k_pool, v_pool, table, mask, k_new, v_new,
                               wblk, woff, wok, *, softcap=0.0):
    """Write-then-attend decode: row b writes k_new/v_new (B, KV, hd) at
    pool[wblk[b], woff[b]] iff wok[b] (pools updated in place), then attends
    its table view.  Returns (B, KV, G, hd) fp32."""
    paged_write_rows(k_pool, k_new, wblk, woff, wok)
    paged_write_rows(v_pool, v_new, wblk, woff, wok)
    return paged_attention_ref(q, k_pool, v_pool, table, mask,
                               softcap=softcap)


def paged_prefill_ref(q, k_pool, v_pool, table, qpos, *, softcap=0.0):
    """Chunk attention through the block table with causality from qpos:
    kv position p is visible to query row r iff p <= qpos[b, r].  q
    (B, KV, R, hd), qpos (B, R).  Returns (B, KV, R, hd) fp32."""
    bs = k_pool.shape[1]
    L = table.shape[1] * bs
    pos = torch.arange(L, device=q.device)
    mask_rows = torch.where(pos[None, None, :] <= qpos[:, :, None].long(),
                            0.0, NEG_INF).to(torch.float32)
    return _bmm_masked_attend(q, paged_view(k_pool, table),
                              paged_view(v_pool, table), mask_rows,
                              softcap=softcap)
