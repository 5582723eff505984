"""Technique C: the low-fluctuation bit-serial decomposition (paper §4.3),
port of :mod:`repro.core.decompose`.

An activation quantized to integer level ``q`` is fed to the crossbar one
binary digit at a time (Eq. 14): ``x = sum_p delta_p 2^p``.  Each bit-plane
read draws an independent RTN state, so the accumulated output
``O_new = sum_p 2^p delta_p w(p)`` has std ``sqrt(sum 4^p delta_p^2)
sigma(w)``, below the single-read ``(sum 2^p delta_p) sigma(w)`` whenever
more than one bit is set (Eqs. 16-18), and energy ``rho sum_p delta_p``
(Eqs. 19-20).

:func:`bitserial_fwd` is the plain arithmetic of the bit-serial kernel
(``kernels/emt_bitserial.py``).  Backward: the decomposition is a zero-mean
perturbation of the ideal matmul, so it gets the ideal-matmul VJP
(:func:`ideal_vjp`, JAX's ``_bwd``): the bit planes' ``sign``/``floor``
have no derivative to take.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashrng
from repro_torch.core.device import DeviceModel
from repro_torch.core.noise import noise_factor


def bit_plane(mag: torch.Tensor, p: int) -> torch.Tensor:
    """delta_p of the non-negative integer-valued float tensor `mag`
    (Eq. 14)."""
    return torch.floor(mag / (2.0 ** p)) % 2.0


def popcount_levels(mag: torch.Tensor, bits: int) -> torch.Tensor:
    """sum_p delta_p: the crossbar reads a level costs (Eq. 19)."""
    return sum(bit_plane(mag, p) for p in range(bits))


def sigma_ratio_theory(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-element theoretical sigma(O_new) / sigma(O_ori) from Eqs. 16-17
    (1.0 where the level is 0 or has a single bit set)."""
    num = torch.zeros(levels.shape, dtype=torch.float32, device=levels.device)
    den = torch.zeros_like(num)
    for p in range(bits):
        d = bit_plane(levels, p).to(torch.float32)
        num = num + (4.0 ** p) * d
        den = den + (2.0 ** p) * d
    return torch.where(den > 0, torch.sqrt(num) / torch.clamp_min(den, 1e-9),
                       torch.ones_like(num))


def bitserial_fwd(xq, w, sig, device: DeviceModel, bits: int, seed=0,
                  base_plane=0) -> torch.Tensor:
    """sum_p 2^p (sign(xq) delta_p(|xq|)) @ (w * (1 + a_p sig)): plane p
    draws its RTN offsets a_p from the counter hash on plane
    ``base_plane + p`` at every weight element's (row, col).

    xq: (..., K) integer-valued float levels (may be negative); w: (K, N);
    sig: sigma_rel(rho) as a float32 tensor.  Returns (..., N) float32.
    """
    kdim, n = w.shape
    sign = torch.sign(xq.to(torch.float32))
    mag = torch.abs(xq.to(torch.float32))
    acc = torch.zeros((*xq.shape[:-1], n), dtype=torch.float32,
                      device=xq.device)
    for p in range(bits):
        offs = hashrng.tile_state_offsets(seed, 0, 0, (kdim, n),
                                          device.state_offsets,
                                          device.state_probs, base_plane + p,
                                          device=w.device)
        wn = (w.to(torch.float32) * noise_factor(offs, sig)).to(w.dtype)
        planes = (sign * bit_plane(mag, p)).to(w.dtype)
        acc = acc + (2.0 ** p) * torch.matmul(planes, wn).to(torch.float32)
    return acc


def bitserial_matmul_ref(xq, w, rho, device: DeviceModel, bits: int, seed=0,
                         base_plane=0) -> torch.Tensor:
    """y = the bit-serial noisy matmul of levels `xq` (..., K) with `w`
    (K, N) at energy coefficient `rho` (a scalar tensor), with the
    ideal-matmul VJP; `seed` is the step's noise seed, taken at run time."""
    def fwd(xq, w, sig):
        return bitserial_fwd(xq, w, sig, device, bits, seed=seed,
                             base_plane=base_plane)
    return ideal_vjp(fwd, xq, w, device.sigma_rel(rho))


class _IdealVJP(torch.autograd.Function):
    """y = forward(xq, w, sig) with JAX's ``decompose._bwd``: gx = g @ w^T
    in xq's dtype, gw = xq^T g in float32, and zero for sig."""

    @staticmethod
    def forward(ctx, xq, w, sig, forward, kw):
        ctx.save_for_backward(xq, w, sig)
        return forward(xq, w, sig, **kw)

    @staticmethod
    def backward(ctx, g):
        xq, w, sig = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(g, w.T).to(xq.dtype)
        if ctx.needs_input_grad[1]:
            lead = xq.reshape(-1, xq.shape[-1]).to(torch.float32)
            gw = torch.matmul(lead.T, g.reshape(-1, g.shape[-1])
                              .to(torch.float32)).to(w.dtype)
        gsig = torch.zeros_like(sig) if ctx.needs_input_grad[2] else None
        return gx, gw, gsig, None, None


def ideal_vjp(forward, xq, w, sig, **kw):
    """forward(xq, w, sig, **kw), differentiable with the ideal-matmul VJP
    when grad mode is on and an input requires it (else the forward alone,
    with no autograd bookkeeping)."""
    if torch.is_grad_enabled() and (xq.requires_grad or w.requires_grad
                                    or sig.requires_grad):
        return _IdealVJP.apply(xq, w, sig, forward, kw)
    return forward(xq, w, sig, **kw)
