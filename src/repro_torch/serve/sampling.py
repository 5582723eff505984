"""Per-slot seeded sampling: temperature / top-k / top-p over (B, V) logit
rows (port of :mod:`repro.serve.sampling`).

Every draw is a pure counter hash of (request seed, generated-token counter,
vocab column) on ``SAMPLING_PLANE``: deterministic per request, independent
of slot placement and co-tenants; the uniforms behind the Gumbel draws are
bit-exact with the JAX engine's.  ``temperature == 0`` rows take the argmax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashrng

SAMPLING_PLANE = 0x5A3D17


def gumbel_uniform(seeds, positions, vocab: int, *, device="cpu"):
    """(B,) request seeds / positions -> (B, vocab) float32 uniforms at
    23-bit precision, strictly inside (0, 1); bit-exact with the JAX draw."""
    seeds = torch.as_tensor(np.asarray(seeds, np.int64) & 0xFFFFFFFF,
                            device=device)[:, None]
    rows = torch.as_tensor(np.asarray(positions, np.int64) & 0xFFFFFFFF,
                           device=device)[:, None]
    cols = torch.arange(vocab, dtype=torch.int64, device=device)[None, :]
    bits = hashrng.hash_counters(seeds, rows, cols, plane=SAMPLING_PLANE)
    return ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / 8388608.0)


def gumbel_noise(seeds, positions, vocab: int, *, device="cpu"):
    """(B, vocab) Gumbel(0, 1) samples -log(-log(u)).  The uniforms are
    bit-exact with JAX; the values agree to float32 log rounding (XLA's CPU
    log is a polynomial approximation, not torch's)."""
    u = gumbel_uniform(seeds, positions, vocab, device=device)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, temperature, top_k, top_p, seeds, positions):
    """One token per row.  `logits` (B, V) is a tensor; the per-row
    arguments are host arrays (B,):

    temperature: 0 -> greedy argmax; > 0 -> softmax sampling.
    top_k:       0 -> disabled; k > 0 -> the k highest logits.
    top_p:       >= 1 (or <= 0) -> disabled; else nucleus mass.
    seeds:       per-request sampling seed (uint32).
    positions:   per-request generated-token counter.
    Returns (B,) int64 on the logits' device.
    """
    B, V = logits.shape
    dev = logits.device
    lf = logits.to(torch.float32)
    greedy = torch.argmax(lf, dim=-1)
    t_np = np.asarray(temperature, np.float32)
    if not (t_np > 0).any():
        return greedy
    t = torch.as_tensor(t_np, device=dev)
    scaled = lf / torch.clamp_min(t, 1e-6)[:, None]

    k = torch.as_tensor(np.asarray(top_k, np.int64), device=dev)
    k = torch.where(k > 0, torch.clamp(k, 1, V), torch.full_like(k, V))
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(srt, 1, (k - 1)[:, None])
    neg = torch.full_like(scaled, -float("inf"))
    masked = torch.where(scaled >= kth, scaled, neg)

    p = torch.as_tensor(np.asarray(top_p, np.float32), device=dev)
    p = torch.where((p <= 0.0) | (p >= 1.0), torch.ones_like(p), p)
    probs = torch.softmax(masked, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sp, dim=-1)
    keep = (cum - sp) < p[:, None]
    pmin = torch.amin(torch.where(keep, sp, torch.full_like(sp, float("inf"))),
                      dim=-1, keepdim=True)
    masked = torch.where(probs >= pmin, masked, neg)

    sampled = torch.argmax(masked + gumbel_noise(seeds, positions, V,
                                                 device=dev), dim=-1)
    return torch.where(t > 0.0, sampled, greedy)
