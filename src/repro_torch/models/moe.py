"""GShard-style top-k mixture of experts on EMT crossbars (port of
:mod:`repro.models.moe`).

Routing, capacity, dispatch and combine follow the reference's dense
one-hot formulation step for step, so that the same rows in the same order
give the same expert queues: top-k ties go to the lowest expert index (a
stable descending sort, as ``lax.top_k``), queue positions come from a
cumsum over the token-major (tokens * k, E) layout, and tokens past an
expert's capacity are dropped in queue order.  Padding lanes and idle rows
route and take capacity too, as in JAX.

Expert weights are (E, D, F) stacks, fake-quantized as one tensor (one
weight scale per output column across all experts) and noised as one
folded (E * D, F) hash draw.  With the hash backend the three expert
products go through :func:`repro_torch.kernels.ops.emt_matmul_experts`
(K3's experts entry on the card: one launch a projection, the noise hashed
in the kernel, the noisy stack's |w~| sum and max returned beside the
product for the accounting, which reads the noisy stacks); the threefry
backend, and a layer with its noise off, materialize the noisy stack and
multiply with einsum, as JAX does.  The experts' inputs are not
DAC-quantized, whatever the rule's mode: a bit-serial rule on the experts
(the "mixed" placement's) still reads them in analog (technique A).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import regularizer
from repro_torch.core.emt_linear import (EMTConfig, _tag_plane, add_aux,
                                         corner_entry, dense_specs, emt_dense,
                                         new_aux)
from repro_torch.core.noise import fluctuate, fold_in
from repro_torch.core.quant import quantize_weights
from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import Ctx
from repro_torch.nn.param import (ParamSpec, constant_init, fan_in_init,
                                  normal_init)

GROUP_SIZE = 2048  # tokens per dispatch group


def moe_specs(cfg: ModelConfig, tag: str = "") -> dict:
    """`tag` is the block's canonical path ("dec/layer_007/moe").  The expert
    stack resolves as one placement unit at `{tag}/experts`; the router is
    digital fp32 unless an explicit rule places it (`{tag}/router`)."""
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    emt = cfg.emt_at(f"{tag}/experts")
    r_emt = cfg.emt_rule_at(f"{tag}/router")
    if r_emt is None:
        router = {"w": ParamSpec((D, E), torch.float32, normal_init(0.02))}
    else:
        router = dense_specs(D, E, r_emt, dtype=torch.float32,
                             init=normal_init(0.02))
    specs = {
        "router": router,
        "wg": ParamSpec((E, D, Fd), cfg.dtype, fan_in_init(fan_axis=1)),
        "wu": ParamSpec((E, D, Fd), cfg.dtype, fan_in_init(fan_axis=1)),
        "wd": ParamSpec((E, Fd, D), cfg.dtype, fan_in_init(fan_axis=1)),
    }
    if emt.active:
        specs["rho_raw"] = ParamSpec(
            (), torch.float32,
            constant_init(regularizer.rho_init_raw(emt.rho_init)))
    return specs


def _emt_stacked(w, rho, emt: EMTConfig, ctx: Ctx, tag: str):
    """Quantize + fluctuate a stacked (E, D, F) expert weight as EMT
    crossbars, the noise materialized (the plain route)."""
    if not emt.active:
        return w
    wq, _ = quantize_weights(w, emt.quant)
    e, d, f = wq.shape
    plane = _tag_plane(tag)
    wn = fluctuate(wq.reshape(e * d, f), rho, emt.device, emt.noise,
                   key=None if ctx.key is None else fold_in(ctx.key, plane),
                   seed=ctx.seed, plane=plane)
    return wn.reshape(e, d, f)


def _experts(xin, w, rho, emt: EMTConfig, ctx: Ctx, tag: str):
    """xin (E, M, K) through the (E, K, N) stack `w` on the crossbars:
    (y (E, M, N), sum |w~|, max |w~|), the two statistics of the noisy
    stack (None when the layer is not active)."""
    from repro_torch.kernels import ops     # kernels depend on core
    if (emt.active and emt.noise.enabled
            and emt.noise.backend == "hash"):
        wq, _ = quantize_weights(w, emt.quant)
        return ops.emt_matmul_experts(xin, wq, emt.device.sigma_rel(rho),
                                      device=emt.device, seed=ctx.seed,
                                      plane=_tag_plane(tag))
    wn = _emt_stacked(w, rho, emt, ctx, tag)
    y = torch.einsum("ecd,edf->ecf", xin, wn)
    if not emt.active:
        return y, None, None
    wf = wn.to(torch.float32)
    return (y, torch.sum(regularizer.jax_abs(wf)),
            torch.amax(torch.abs(wf.detach())))


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots of each expert's queue for a dispatch group of `tokens`:
    capacity_factor * tokens * k / E, rounded up to a multiple of 4, at
    least 4 and at most the group (4 at a moonshot decode step of 4 rows,
    8 at a chunk step of 64 lanes)."""
    cap = int(np.ceil(tokens / cfg.num_experts * cfg.capacity_factor
                      * cfg.experts_per_token))
    return max(4, min(tokens, -(-cap // 4) * 4))


def moe_ffn(params, x, cfg: ModelConfig, *, ctx: Ctx, tag: str):
    """x: (B, S, D) -> (B, S, D). Returns (y, aux)."""
    B, S, D = x.shape
    E = cfg.num_experts
    K = cfg.experts_per_token
    T = B * S
    sg = min(GROUP_SIZE, T)
    assert T % sg == 0, (T, sg)
    G = T // sg
    cap = capacity(cfg, sg)

    xt = x.reshape(G, sg, D)
    emt = cfg.emt_at(f"{tag}/experts")
    r_emt = cfg.emt_rule_at(f"{tag}/router")

    # --- routing (fp32; digital unless explicitly placed) -----------------
    r_aux = None
    if r_emt is None:
        logits = xt.to(torch.float32) @ params["router"]["w"]   # (G, s, E)
    else:
        logits, r_aux = emt_dense(params["router"], xt.to(torch.float32),
                                  r_emt, tag=f"{tag}/router", seed=ctx.seed,
                                  key=ctx.key)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the largest first, equal values in index order
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :K], gate_idx[..., :K]  # (G, s, K)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, -1, keepdim=True), 1e-9)

    # --- capacity assignment ----------------------------------------------
    onehot = F.one_hot(gate_idx, E).to(torch.float32)          # (G, s, K, E)
    # position of each (token, k) within its expert queue
    pos = torch.cumsum(onehot.reshape(G, sg * K, E), dim=1).reshape(
        G, sg, K, E) * onehot - 1.0
    keep = (pos >= 0) & (pos < cap)
    slots = torch.arange(cap, device=x.device, dtype=torch.float32)
    kept = ((pos[..., None] == slots) & keep[..., None]).to(torch.float32)
    disp = torch.einsum("gske,gskec->gsec", onehot, kept)
    comb = torch.einsum("gske,gskec,gsk->gsec", onehot, kept, gate_vals)

    # --- dispatch -> experts -> combine -----------------------------------
    expert_in = torch.einsum("gsec,gsd->gecd", disp.to(cfg.dtype), xt)
    rho = (regularizer.rho_from_raw(params["rho_raw"]) if emt.active
           else torch.ones((), device=x.device))
    # every group's queues of an expert as one row block of its product
    xin = expert_in.transpose(0, 1).reshape(E, G * cap, D)
    g, s_g, m_g = _experts(xin, params["wg"], rho, emt, ctx, f"{tag}/wg")
    u, s_u, _ = _experts(xin, params["wu"], rho, emt, ctx, f"{tag}/wu")
    h = common.activation(cfg.act)(g) * u
    out, s_d, _ = _experts(h, params["wd"], rho, emt, ctx, f"{tag}/wd")
    expert_out = out.reshape(E, G, cap, D).transpose(0, 1)     # (G,E,cap,D)
    y = torch.einsum("gsec,gecd->gsd", comb.to(cfg.dtype), expert_out)
    y = y.reshape(B, S, D)

    # --- aux: load-balance + z losses (fp32), EMT accounting ---------------
    aux = new_aux()
    me = torch.mean(probs, dim=(0, 1))                            # (E,)
    ce = torch.mean(onehot.sum(2), dim=(0, 1))                    # (E,)
    aux["aux_loss"] = (cfg.router_aux_weight * E * torch.sum(me * ce)
                       + 1e-3 * torch.mean(
                           torch.square(torch.logsumexp(logits, dim=-1))))
    if r_aux is not None:
        aux = add_aux(aux, r_aux)
    if emt.active and emt.energy_accounting != "off":
        tokens_per_expert = float(T) * K / E
        cells = 0
        for w_sum, w in ((s_g, params["wg"]), (s_u, params["wu"]),
                         (s_d, params["wd"])):
            aux["reg"] = aux["reg"] + 1.0 * rho * w_sum / w.shape[-1]
            cells += math.prod(w.shape)
        x_level = torch.mean(torch.abs(expert_in)).detach() * 32.0
        w_norm = (s_g + s_u + s_d).detach()
        e_pj = emt.device.mac_energy(
            rho.detach(), w_norm / torch.clamp_min(m_g.detach(), 1e-8),
            x_level, tokens_per_expert / max(1, E)).to(torch.float32)
        reads = float(np.float32(T * K * D))
        expert_aux = new_aux()
        expert_aux.update(
            energy_pj=e_pj, reads=reads, cells=cells,
            rho_sum=rho.detach(), rho_layers=1,
            corners={emt.corner_label: corner_entry(e_pj, reads, cells)})
        aux = add_aux(aux, expert_aux)
    return y, aux
