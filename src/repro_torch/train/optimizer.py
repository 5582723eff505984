"""Optimizers from scratch: SGD-momentum, AdamW, Adafactor (port of
:mod:`repro.train.optimizer`).

Each optimizer exposes

    init(params)                          -> state (dicts mirroring params)
    update(grads, state, params, lr, step) -> (new_params, new_state)

The state mirrors the parameter tree leaf for leaf with JAX's keys (``m``,
``v``; Adafactor's factored ``vr``/``vc`` or ``v``), so a checkpoint of
either package restores in the other.  Updates are computed in float32
whatever the parameter dtype.  As in JAX, an update returns new tensors
(the old state is not written); the new parameters require grad again.
The sharding half (``shardings_from_abstract``) waits for multi-device
training (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.utils.pytrees import flatten_with_paths, unflatten_paths

f32 = torch.float32


def _leaves(tree):
    return [leaf for _, leaf in flatten_with_paths(tree)]


def _map(fn, tree):
    """fn over the leaves of `tree`, the same tree structure back."""
    return unflatten_paths((p, fn(leaf)) for p, leaf in
                           flatten_with_paths(tree))


def _at_paths(tree, paths):
    out = []
    for path in paths:
        node = tree
        for part in path.split("/"):
            node = node[part]
        out.append(node)
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of sum(x^2), fp32."""
    total = sum(torch.sum(torch.square(x.to(f32))) for x in _leaves(tree))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    """(grads * min(1, max_norm / max(norm, 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return _map(lambda g: (g.to(f32) * scale).to(g.dtype), grads), norm


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # adamw | sgd | adafactor
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    min_dim_factored: int = 128


class Optimizer:
    def __init__(self, cfg: OptimizerConfig):
        if cfg.name not in ("adamw", "sgd", "adafactor"):
            raise ValueError(cfg.name)
        self.cfg = cfg

    def init(self, params):
        c = self.cfg

        def zeros(shape, like):
            return torch.zeros(shape, dtype=f32, device=like.device)

        def one(p):
            if c.name == "sgd":
                return {"m": zeros(p.shape, p)}
            if c.name == "adamw":
                return {"m": zeros(p.shape, p), "v": zeros(p.shape, p)}
            if p.dim() >= 2 and min(p.shape[-2:]) >= c.min_dim_factored:
                return {"vr": zeros(p.shape[:-1], p),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:], p)}
            return {"v": zeros(p.shape, p)}
        return _map(one, params)

    @torch.no_grad()
    def update(self, grads, state, params, lr, step: int):
        """One step at learning rate `lr` (a float) for the 0-based `step`;
        returns (new_params, new_state)."""
        c = self.cfg
        stepf = torch.tensor(float(step) + 1.0, dtype=f32)

        def bias(b):
            # 1 - b ** stepf in float32, as jnp evaluates it
            return float(1.0 - torch.pow(torch.tensor(b, dtype=f32), stepf))

        bc1, bc2 = bias(c.b1), bias(c.b2)

        def upd(g, s, p):
            g = g.to(f32)
            pf = p.to(f32)
            if c.name == "sgd":
                m = c.momentum * s["m"] + g
                delta = lr * m
                new_s = {"m": m}
            elif c.name == "adamw":
                m = c.b1 * s["m"] + (1 - c.b1) * g
                v = c.b2 * s["v"] + (1 - c.b2) * g * g
                mh = m / bc1
                vh = v / bc2
                delta = lr * (mh / (torch.sqrt(vh) + c.eps)
                              + c.weight_decay * pf)
                new_s = {"m": m, "v": v}
            else:        # adafactor (no momentum, factored second moment)
                beta2 = float(1.0 - torch.pow(stepf, -c.decay_rate))
                g2 = g * g + 1e-30
                if "vr" in s:
                    vr = beta2 * s["vr"] + (1 - beta2) * torch.mean(g2, -1)
                    vc = beta2 * s["vc"] + (1 - beta2) * torch.mean(g2, -2)
                    r = vr / torch.clamp_min(
                        torch.mean(vr, -1, keepdim=True), 1e-30)
                    precond = 1.0 / torch.sqrt(
                        r[..., None] * vc[..., None, :] + 1e-30)
                    new_s = {"vr": vr, "vc": vc}
                else:
                    v = beta2 * s["v"] + (1 - beta2) * g2
                    precond = 1.0 / torch.sqrt(v + 1e-30)
                    new_s = {"v": v}
                u = g * precond
                # update clipping (Adafactor RMS rule)
                rms = torch.sqrt(torch.mean(u * u) + 1e-30)
                u = u / torch.clamp_min(rms, 1.0)
                delta = lr * (u + c.weight_decay * pf)
            new_p = (pf - delta).to(p.dtype).requires_grad_(p.requires_grad)
            return new_p, new_s

        paths = [p for p, _ in flatten_with_paths(grads)]
        flat_s = _at_paths(state, paths)
        flat_p = _at_paths(params, paths)
        out = [upd(g, s, p) for g, s, p in zip(_leaves(grads), flat_s,
                                                flat_p)]
        return (unflatten_paths(zip(paths, (o[0] for o in out))),
                unflatten_paths(zip(paths, (o[1] for o in out))))


# ---------------------------------------------------------------- schedules
def cosine_schedule(base_lr, warmup: int, total: int, min_ratio=0.1):
    """Linear warmup to base_lr, then cosine decay to min_ratio * base_lr,
    evaluated in float32 as JAX evaluates it; lr(step) is a float."""
    def lr(step):
        s = np.float32(step)
        warm = np.float32(base_lr) * min(np.float32(1.0),
                                         (s + np.float32(1.0))
                                         / np.float32(max(1, warmup)))
        t = np.clip((s - np.float32(warmup))
                    / np.float32(max(1, total - warmup)),
                    np.float32(0.0), np.float32(1.0))
        cos = np.float32(min_ratio) + np.float32(1 - min_ratio) * \
            np.float32(0.5) * (np.float32(1.0)
                               + np.cos(np.float32(math.pi) * t))
        return float(warm if s < warmup else np.float32(base_lr) * cos)
    return lr


def constant_schedule(base_lr):
    return lambda step: float(np.float32(base_lr))
