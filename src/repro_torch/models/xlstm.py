"""xLSTM blocks: the chunkwise-parallel mLSTM (matrix memory) and the
sLSTM (port of :mod:`repro.models.xlstm`).

The gates are bounded (``f = sigmoid``, ``i = exp(min(i~, 0))``), so every
decay exponent is <= 0 and the chunkwise mLSTM is plain linear algebra,
chunks of ``MLSTM_CHUNK`` positions with exact inter-chunk state algebra.
Its operations come in JAX's order, and so does a fact of the reference:
inside a chunk, ``exp(d)`` of the decay matrix is taken before the causal
mask multiplies it, and for j > t that exponent, a sum of -log f, grows
with j - t.  A chunk of 128 positions can overflow float32's ``exp`` to
inf, and inf * 0 gives NaN logits (``repro/models/xlstm.py:74``); the port
gives the same NaN, unguarded.

The sLSTM runs input-gated (recurrent matrices unused), a linear scan
through :func:`repro_torch.models.mamba._selective_scan`; with
``cfg.slstm_recurrent`` a prompt of more than one token runs the exact
R-matrix recurrence token by token (JAX's ``lax.scan``; its gates' energy
is not booked and it returns no state, as in JAX).

EMT: every projection is a crossbar read through ``emt_dense`` (K3 in
analog); the state updates are not stored-weight MACs and run ideal.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.emt_linear import add_aux, dense_specs, emt_dense, new_aux
from repro_torch.core.regularizer import softplus
from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.models.mamba import _causal_depthwise_conv, _selective_scan
from repro_torch.nn.param import ParamSpec, constant_init

MLSTM_CHUNK = 2048


def _dense(params, x, cfg: ModelConfig, ctx: Ctx, tag: str, name: str):
    return emt_dense(params[name], x, cfg.emt_at(f"{tag}/{name}"),
                     tag=f"{tag}/{name}", seed=ctx.seed, key=ctx.key)


def _log_sigmoid(x):
    """jax.nn.log_sigmoid's form: -softplus(-x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_specs(cfg: ModelConfig, tag: str = "") -> dict:
    D = cfg.d_model
    DI = 2 * D                       # projection factor 2 (xLSTM paper)
    H = cfg.num_heads
    e = cfg.emt_at

    def dense(d_in, d_out, name, bias=False):
        return dense_specs(d_in, d_out, e(f"{tag}/{name}"), dtype=cfg.dtype,
                           bias=bias)

    return {
        "up": dense(D, 2 * DI, "up"),
        "conv_w": ParamSpec((4, DI), cfg.dtype, constant_init(0.1)),
        "conv_b": ParamSpec((DI,), cfg.dtype, constant_init(0.0)),
        "wq": dense(DI, DI, "wq"),
        "wk": dense(DI, DI, "wk"),
        "wv": dense(DI, DI, "wv"),
        "wi": dense(DI, H, "wi", bias=True),
        "wf": dense(DI, H, "wf", bias=True),
        "out_norm": common.rmsnorm_specs(DI),
        "down": dense(DI, D, "down"),
    }


def _mlstm_chunk(q, k, v, log_f, log_i, C0, n0):
    """One chunk of the chunkwise-parallel mLSTM.  q, k, v (B, H, c, hd);
    log_f, log_i (B, H, c), both <= 0; C0 (B, H, hd, hd), n0 (B, H, hd).
    Returns (y (B, H, c, hd), C1, n1)."""
    hd = q.shape[-1]
    lfc = torch.cumsum(log_f, dim=-1)                # inclusive sum of log f
    lf_total = lfc[..., -1]
    # intra-chunk decay: d_tj = lfc_t - lfc_j + log_i_j (used for j <= t)
    d = lfc[..., :, None] - lfc[..., None, :] + log_i[..., None, :]
    c = q.shape[2]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    att = torch.einsum("bhtd,bhjd->bhtj", q, k) / np.sqrt(hd)
    att = att * torch.exp(d) * tri
    y_intra = torch.einsum("bhtj,bhjd->bhtd", att, v)
    n_intra = torch.einsum("bhtj,bhjd->bhtd", torch.exp(d) * tri, k)

    # inter-chunk: the state of the previous chunks decayed to t
    decay_t = torch.exp(lfc)[..., None]              # (B, H, c, 1)
    y_inter = torch.einsum("bhtd,bhde->bhte", q, C0) * decay_t / np.sqrt(hd)
    n_inter = n0[:, :, None] * decay_t

    n_t = n_intra + n_inter
    denom = torch.clamp_min(
        torch.abs(torch.einsum("bhtd,bhtd->bht", q, n_t)) / np.sqrt(hd), 1.0)
    y = (y_intra + y_inter) / denom[..., None]

    # the state at the chunk's end
    w = torch.exp(lf_total[..., None] - lfc + log_i)  # (B, H, c)
    C1 = (torch.exp(lf_total)[..., None, None] * C0
          + torch.einsum("bhj,bhjd,bhje->bhde", w, k, v))
    n1 = (torch.exp(lf_total)[..., None] * n0
          + torch.einsum("bhj,bhjd->bhd", w, k))
    return y, C1, n1


def mlstm(params, x, cfg: ModelConfig, *, ctx: Ctx, tag: str, state=None):
    """Returns (y, aux, new state); state = {"C": (B, H, hd, hd), "n": (B,
    H, hd), "conv": (B, 3, DI)}."""
    B, S, D = x.shape
    H = cfg.num_heads
    DI = 2 * D
    hd = DI // H
    aux = new_aux()

    up, a = _dense(params, x, cfg, ctx, tag, "up")
    aux = add_aux(aux, a)
    xm, z = torch.chunk(up, 2, dim=-1)
    xc, new_conv = _causal_depthwise_conv(
        xm, params["conv_w"], params["conv_b"],
        None if state is None else state["conv"])
    xc = F.silu(xc)

    heads = {}
    for nm, src in (("wq", xc), ("wk", xc), ("wv", xm)):
        o, a = _dense(params, src, cfg, ctx, tag, nm)
        aux = add_aux(aux, a)
        heads[nm] = o.reshape(B, S, H, hd).permute(0, 2, 1, 3).to(
            torch.float32)
    q, k, v = heads["wq"], heads["wk"], heads["wv"]

    gi, a = _dense(params, xc, cfg, ctx, tag, "wi")
    aux = add_aux(aux, a)
    gf, a = _dense(params, xc, cfg, ctx, tag, "wf")
    aux = add_aux(aux, a)
    log_i = _log_sigmoid(gi.to(torch.float32)).transpose(1, 2)     # <= 0
    log_f = _log_sigmoid(gf.to(torch.float32)).transpose(1, 2)     # <= 0

    if state is None:
        C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device)
        n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    else:
        C0, n0 = state["C"], state["n"]

    ys = []
    chunk = min(MLSTM_CHUNK, S)
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        y, C0, n0 = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                 log_f[:, :, sl], log_i[:, :, sl], C0, n0)
        ys.append(y)
    y = torch.cat(ys, dim=2)                                       # (B,H,S,hd)
    y = y.permute(0, 2, 1, 3).reshape(B, S, DI).to(cfg.dtype)
    y = common.rmsnorm(params["out_norm"], y, cfg.norm_eps) * F.silu(z)
    out, a = _dense(params, y, cfg, ctx, tag, "down")
    return out, add_aux(aux, a), {"C": C0, "n": n0, "conv": new_conv}


def mlstm_state_specs(cfg: ModelConfig, batch: int) -> dict:
    """Decode-state entries, ``{name: (shape, dtype)}``."""
    H = cfg.num_heads
    DI = 2 * cfg.d_model
    hd = DI // H
    return {"C": ((batch, H, hd, hd), torch.float32),
            "n": ((batch, H, hd), torch.float32),
            "conv": ((batch, 3, DI), cfg.dtype)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_specs(cfg: ModelConfig, tag: str = "") -> dict:
    D = cfg.d_model
    F_ = -(-4 * D // 3 // 128) * 128  # proj factor 4/3, aligned
    e = cfg.emt_at
    specs = {nm: dense_specs(D, D, e(f"{tag}/{nm}"), dtype=cfg.dtype,
                             bias=True) for nm in ("wz", "wi", "wf", "wo")}
    # the exact variant's recurrent matrices (read when slstm_recurrent)
    specs.update({nm: ParamSpec((D, D), cfg.dtype, constant_init(0.0))
                  for nm in ("rz", "ri", "rf", "ro")})
    specs["up"] = dense_specs(D, 2 * F_, e(f"{tag}/up"), dtype=cfg.dtype)
    specs["down"] = dense_specs(F_, D, e(f"{tag}/down"), dtype=cfg.dtype)
    return specs


def _slstm_gates(params, x, cfg, ctx, tag, aux, h_prev=None):
    outs = {}
    for nm in ("wz", "wi", "wf", "wo"):
        o, a = _dense(params, x, cfg, ctx, tag, nm)
        aux = add_aux(aux, a)
        if h_prev is not None:
            o = o + h_prev @ params["r" + nm[1]]
        outs[nm] = o.to(torch.float32)
    return outs, aux


def slstm(params, x, cfg: ModelConfig, *, ctx: Ctx, tag: str, state=None):
    """Returns (y, aux, new state); state = {"c": (B, D), "n": (B, D)}
    (None from the exact recurrence)."""
    B, S, D = x.shape
    aux = new_aux()

    if cfg.slstm_recurrent and S > 1:
        f32 = dict(dtype=torch.float32, device=x.device)
        c, n = torch.zeros((B, D), **f32), torch.zeros((B, D), **f32)
        h = torch.zeros((B, D), dtype=x.dtype, device=x.device)
        hs = []
        for t in range(S):
            g, _ = _slstm_gates(params, x[:, t:t + 1], cfg, ctx, tag,
                                new_aux(), h_prev=h[:, None])
            z = torch.tanh(g["wz"][:, 0])
            i = torch.exp(torch.clamp_max(g["wi"][:, 0], 0.0))
            f = torch.sigmoid(g["wf"][:, 0])
            o = torch.sigmoid(g["wo"][:, 0])
            c = f * c + i * z
            n = f * n + i
            h = (o * c / torch.clamp_min(n, 1.0)).to(x.dtype)
            hs.append(h)
        h = torch.stack(hs, dim=1)
        new_state = None
    else:
        g, aux = _slstm_gates(params, x, cfg, ctx, tag, aux)
        z = torch.tanh(g["wz"])
        log_i = torch.clamp_max(g["wi"], 0.0)
        log_f = _log_sigmoid(g["wf"])
        o = torch.sigmoid(g["wo"])
        f = torch.exp(log_f)
        i = torch.exp(log_i)
        c0 = None if state is None else state["c"]
        n0 = None if state is None else state["n"]
        if S == 1 and c0 is not None:
            c_all = (f[:, 0] * c0 + i[:, 0] * z[:, 0])[:, None]
            n_all = (f[:, 0] * n0 + i[:, 0])[:, None]
        else:
            c_all, _ = _selective_scan(f, i * z, c0)
            n_all, _ = _selective_scan(f, i, n0)
        h = (o * c_all / torch.clamp_min(n_all, 1.0)).to(x.dtype)
        new_state = {"c": c_all[:, -1], "n": n_all[:, -1]}

    up, a = _dense(params, h, cfg, ctx, tag, "up")
    aux = add_aux(aux, a)
    u, gglu = torch.chunk(up, 2, dim=-1)
    y, a = _dense(params, common.activation("gelu")(gglu) * u, cfg, ctx, tag,
                  "down")
    return y, add_aux(aux, a), new_state


def slstm_state_specs(cfg: ModelConfig, batch: int) -> dict:
    """Decode-state entries, ``{name: (shape, dtype)}``."""
    return {"c": ((batch, cfg.d_model), torch.float32),
            "n": ((batch, cfg.d_model), torch.float32)}
