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
from repro_torch.core.regularizer import jax_abs

# The additive-mask sentinel; must equal models.common.NEG_INF.
NEG_INF = -1e30


# Elements the plain noise hashes at a time.  The hash runs in several
# weight-sized int64 temporaries: a whole tied unembed of gemma2-9b (3,584 x
# 256,000) or llama3-405b's head (16,384 x 128,256, 2.1 G elements) in one
# go would need tens of GB of them beside the model.
NOISE_SLAB = 1 << 26


def _row_slabs(kdim: int, n: int):
    """(r0, r1) row ranges of at most NOISE_SLAB elements (one row at
    least)."""
    rows = max(1, NOISE_SLAB // max(n, 1))
    return [(r, min(kdim, r + rows)) for r in range(0, kdim, rows)]


def _noise(w, sig, device: DeviceModel, seed, plane, row0: int = 0):
    """(a, f): the RTN offsets hashed at every weight element's global
    (row0 + row, col) and the read factor fl(1 + a * sig),
    weight-shaped; hashed NOISE_SLAB elements of rows at a time (the same
    values: every element's hash is its own)."""
    kdim, n = w.shape
    offs = torch.empty((kdim, n), dtype=torch.float32, device=w.device)
    for r0, r1 in _row_slabs(kdim, n):
        offs[r0:r1] = hashrng.tile_state_offsets(
            seed, row0 + r0, 0, (r1 - r0, n), device.state_offsets,
            device.state_probs, plane, device=w.device)
    return offs, noise_factor(offs, sig)


def noisy_weight(w, sig, device: DeviceModel, seed=0, plane=0):
    """fl(w * f) in w's dtype and strides (a BLAS product sums in an order
    that follows them), built NOISE_SLAB elements of rows at a time, so
    that no weight-sized offset or factor tensor exists beside it."""
    out = torch.empty_like(w)
    for r0, r1 in _row_slabs(*w.shape):
        _, f = _noise(w[r0:r1], sig, device, seed, plane, row0=r0)
        out[r0:r1] = (w[r0:r1].to(torch.float32) * f).to(w.dtype)
    return out


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
    wn = noisy_weight(w, sig, device, seed, plane)
    return torch.matmul(x, wn).to(torch.float32)


def noisy_experts(w, sig, *, device: DeviceModel, seed=0, plane=0):
    """The noisy (E, K, N) expert stack: ``fluctuate`` of the folded
    (E * K, N) stack (expert e's element (k, n) hashed at row e * K + k),
    reshaped back."""
    e, kdim, n = w.shape
    # one expert at a time, at its rows of the folded stack: the hash's
    # int64 temporaries stay one expert's size (jamba's 16 x 4,096 x
    # 14,336 stack would need ~30 GB of them at once)
    return torch.stack([
        w[i] * _noise(w[i], sig, device, seed, plane,
                      row0=i * kdim)[1].to(w.dtype) for i in range(e)])


def emt_matmul_experts_ref(x, w, sig, *, device: DeviceModel, seed=0,
                           plane=0):
    """A stack of E experts' products: x (E, M, K) @ noisy(w (E, K, N)) ->
    (E, M, N) float32, with the noise of the folded (E * K, N) stack, so
    expert e's element (k, n) hashes at row e * K + k (JAX's
    ``moe._emt_stacked``: ``fluctuate`` of ``w.reshape(E * K, N)``), and
    the noisy stack's sum |w~| and max |w~| (float32 scalars, JAX's
    ``moe_ffn`` accounting).  Differentiable in x, w and sig; the sum's
    |.| has JAX's derivative at 0 (regularizer.jax_abs), as technique B's
    term over it needs."""
    wn = noisy_experts(w, sig, device=device, seed=seed, plane=plane)
    y = torch.bmm(x, wn).to(torch.float32)
    wf = wn.to(torch.float32)
    return (y, torch.sum(jax_abs(wf)),
            torch.amax(torch.abs(wf.detach())))


def emt_matmul_experts_dx_ref(g, w, sig, *, device: DeviceModel, seed=0,
                              plane=0):
    """The input gradient of emt_matmul_experts_ref for the cotangent g (E,
    M, N): dx[e] = g[e] @ (w[e] * f)^T, expert e's factor hashed at rows e
    * K + k of the folded stack, one expert at a time (so no stack-sized
    noise exists beside it).  Returns (E, M, K) in g's dtype."""
    kdim = w.shape[1]
    return torch.stack([
        torch.matmul(g[i], (w[i] * _noise(w[i], sig, device, seed, plane,
                                          row0=i * kdim)[1]).to(g.dtype).T)
        for i in range(w.shape[0])])


def emt_matmul_experts_dw_ref(x, g, w, sig, gs=None, *, device: DeviceModel,
                              seed=0, plane=0):
    """(dw, dsig) of emt_matmul_experts_ref for the cotangents g (E, M, N)
    of the product and gs (a scalar tensor, or None for none) of the noisy
    stack's sum |w~|: with c = x[e]^T g[e] + gs * sgn(w~) (sgn +1 where
    fl(w f) >= 0: jax_abs's derivative), dw[e] = c * f and dsig = sum (c *
    w) * a over every expert, the rounding of XLA's VJP of ``w * (1 + a *
    sig)`` with the stack's two cotangents added.  One expert at a time,
    its noise at rows e * K + k; dw in the dtype of x^T g."""
    kdim = w.shape[1]
    dws, dsig = [], []
    for i in range(w.shape[0]):
        offs, f = _noise(w[i], sig, device, seed, plane, row0=i * kdim)
        c = torch.matmul(x[i].T, g[i])
        if gs is not None:
            gsc = gs.reshape(()).to(c.dtype)
            c = c + torch.where(w[i] * f >= 0, gsc, -gsc)
        dws.append(c * f)
        dsig.append(torch.sum((c * w[i]) * offs))
        del offs, f, c
    return torch.stack(dws), torch.sum(torch.stack(dsig))


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
