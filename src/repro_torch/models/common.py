"""Shared model components: norms, activations, rotary embeddings, masks,
embeddings (port of :mod:`repro.models.common`)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.emt_linear import EMTConfig, dense_specs, emt_dense
from repro_torch.nn.param import ParamSpec, normal_init, ones_init

NEG_INF = -1e30


def rmsnorm_specs(d):
    return {"scale": ParamSpec((d,), torch.float32, ones_init)}


def rmsnorm(params, x, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def activation(name):
    """JAX's ``jax.nn.gelu`` defaults to the tanh form, so "gelu" is the
    tanh approximation here too (the exact erf form differs by up to 5e-4)."""
    def gelu(x):
        return F.gelu(x, approximate="tanh")
    return {"silu": F.silu, "gelu": gelu, "relu": F.relu,
            "gelu_tanh": gelu}[name]


def softcap(x, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


def _rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta=10000.0):
    """x (B, S, H, hd); positions (B, S) int -> same shape, rotated."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(_rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_mask(q_pos, k_pos, window: int = 0):
    """q_pos (B, Sq), k_pos (B, Sk) -> (B, 1, Sq, Sk) additive mask."""
    q = q_pos[:, None, :, None]
    k = k_pos[:, None, None, :]
    ok = k <= q
    if window and window > 0:
        ok = ok & (q - k < window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def full_mask(q_valid, k_valid):
    """Bidirectional (encoder / cross) mask from validity flags (B, Sq) and
    (B, Sk) -> (B, 1, Sq, Sk) additive."""
    ok = q_valid[:, None, :, None] & k_valid[:, None, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_valid.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def embedding_specs(vocab, d, dtype):
    return {"table": ParamSpec((vocab, d), dtype, normal_init(0.02))}


def embed(params, tokens, scale: bool, d: int):
    y = params["table"][tokens.long()]
    if scale:
        y = y * float(np.float32(np.sqrt(d)))
    return y


def unembed_specs(d, vocab, emt: EMTConfig, dtype):
    return dense_specs(d, vocab, emt, dtype=dtype, init=normal_init(0.02))


def unembed(params, x, emt: EMTConfig, *, tied_table=None, seed=0,
            key=None):
    """Vocabulary logits.  With tied embeddings the table's transpose (a
    strided view, no copy) is the crossbar, still through emt_dense."""
    if tied_table is not None:
        p = dict(params)
        p["w"] = tied_table.T
        return emt_dense(p, x, emt, tag="unembed", seed=seed, key=key)
    return emt_dense(params, x, emt, tag="unembed", seed=seed, key=key)
