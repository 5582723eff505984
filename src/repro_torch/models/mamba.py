"""Mamba selective-SSM block, jamba's sequence mixer (port of
:mod:`repro.models.mamba`).

The selective scan is the linear recurrence ``h_t = dA_t * h_{t-1} +
dBx_t``, computed as a log-depth (Hillis-Steele) inclusive scan under JAX's
combine ``(al * ar, ar * bl + br)`` in chunks of ``SCAN_CHUNK`` positions,
each chunk's prefix applied to the carried state.  A one-token step with a
state runs the recurrence once.  The products' prefix is never divided out
(a cumprod/cumsum form divides by products that underflow).

EMT: the in/x/dt/out projections are crossbar reads through ``emt_dense``
(K3 in analog, K5 bit-serial); the depthwise convolution and the
recurrence are not stored-weight MACs and run ideal, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.emt_linear import add_aux, dense_specs, emt_dense, new_aux
from repro_torch.core.regularizer import softplus
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.nn.param import ParamSpec, constant_init, normal_init

SCAN_CHUNK = 4096


def mamba_specs(cfg: ModelConfig, tag: str = "") -> dict:
    """`tag` is the block's canonical path ("dec/layer_007/mamba"); the
    projections resolve at its suffixes in/xp/dt/out."""
    D, DI, N, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank

    def a_init(gen, shape, dtype, device):
        # S4D-real: A = -(1..N) per channel
        a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
        return torch.log(a[None].repeat(DI, 1)).to(dtype)

    return {
        "in_proj": dense_specs(D, 2 * DI, cfg.emt_at(f"{tag}/in"),
                               dtype=cfg.dtype),
        "conv_w": ParamSpec((cfg.ssm_conv, DI), cfg.dtype, normal_init(0.1)),
        "conv_b": ParamSpec((DI,), cfg.dtype, constant_init(0.0)),
        "x_proj": dense_specs(DI, R + 2 * N, cfg.emt_at(f"{tag}/xp"),
                              dtype=cfg.dtype),
        "dt_proj": dense_specs(R, DI, cfg.emt_at(f"{tag}/dt"),
                               dtype=cfg.dtype, bias=True),
        "A_log": ParamSpec((DI, N), torch.float32, a_init),
        "D_skip": ParamSpec((DI,), torch.float32, constant_init(1.0)),
        "out_proj": dense_specs(DI, D, cfg.emt_at(f"{tag}/out"),
                                dtype=cfg.dtype),
    }


def _causal_depthwise_conv(x, w, b, state=None):
    """x (B, S, DI), w (K, DI); `state` (B, K - 1, DI) is the carried
    context (zeros when None).  Returns (y, the new state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return y + b, xp[:, -(K - 1):]


def _scan(a, b):
    """Inclusive scan of (a, b) along dim 1 under (al * ar, ar * bl + br),
    Hillis-Steele: log2(S) rounds, each combining every position with the
    one `step` before it."""
    S = a.shape[1]
    step = 1
    while step < S:
        a, b = (torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1),
                torch.cat([b[:, :step], a[:, step:] * b[:, :-step]
                           + b[:, step:]], dim=1))
        step *= 2
    return a, b


def _selective_scan(dA, dBx, h0=None, chunk=SCAN_CHUNK):
    """h_t = dA_t * h_{t-1} + dBx_t over dim 1 (h_{-1} = h0, or 0).
    Returns (h_all, h_last)."""
    S = dA.shape[1]
    chunk = min(chunk, S)
    outs = []
    h_prev = h0
    for s0 in range(0, S, chunk):
        a_cum, local = _scan(dA[:, s0:s0 + chunk], dBx[:, s0:s0 + chunk])
        h = local if h_prev is None else a_cum * h_prev[:, None] + local
        outs.append(h)
        h_prev = h[:, -1]
    return torch.cat(outs, dim=1), h_prev


def mamba(params, x, cfg: ModelConfig, *, ctx: Ctx, tag: str, state=None):
    """Mix the sequence x (B, S, D).  `state` (decode and the legacy
    prefill): {"h": (B, DI, N), "conv": (B, K - 1, DI)}; with S == 1 and a
    state, one recurrent step.  Returns (y, aux, new state)."""
    S = x.shape[1]
    N, R = cfg.ssm_state, cfg.dt_rank
    aux = new_aux()

    def dense(name, suffix, inp):
        nonlocal aux
        y, a = emt_dense(params[name], inp, cfg.emt_at(f"{tag}/{suffix}"),
                         tag=f"{tag}/{suffix}", seed=ctx.seed, key=ctx.key)
        aux = add_aux(aux, a)
        return y

    x_in, z = torch.chunk(dense("in_proj", "in", x), 2, dim=-1)
    x_c, new_conv = _causal_depthwise_conv(
        x_in, params["conv_w"], params["conv_b"],
        None if state is None else state["conv"])
    x_c = F.silu(x_c)
    dt_r, Bm, Cm = torch.split(dense("x_proj", "xp", x_c), [R, N, N], dim=-1)
    dt = softplus(dense("dt_proj", "dt", dt_r).to(torch.float32))  # (B,S,DI)

    A = -torch.exp(params["A_log"])                                 # (DI,N)
    dA = torch.exp(dt[..., None] * A)                               # (B,S,DI,N)
    dBx = ((dt * x_c.to(torch.float32))[..., None]
           * Bm.to(torch.float32)[:, :, None, :])                   # (B,S,DI,N)

    h0 = None if state is None else state["h"]
    if S == 1 and h0 is not None:
        h_last = dA[:, 0] * h0 + dBx[:, 0]
        h_all = h_last[:, None]
    else:
        h_all, h_last = _selective_scan(dA, dBx, h0)

    y = torch.einsum("bsdn,bsn->bsd", h_all, Cm.to(torch.float32))
    y = y + params["D_skip"] * x_c.to(torch.float32)
    y = y.to(cfg.dtype) * F.silu(z)
    return dense("out_proj", "out", y), aux, {"h": h_last, "conv": new_conv}


def mamba_state_specs(cfg: ModelConfig, batch: int) -> dict:
    """Decode-state entries, ``{name: (shape, dtype)}``."""
    return {"h": ((batch, cfg.d_inner, cfg.ssm_state), torch.float32),
            "conv": ((batch, cfg.ssm_conv - 1, cfg.d_inner), cfg.dtype)}
