"""The train step on one device (port of :mod:`repro.train.step`).

``make_train_step`` assembles loss -> backward -> clip -> schedule ->
optimizer into one function, train_step(state, batch) -> (state,
metrics), for a language model (:func:`repro_torch.models.lm.train_loss`)
or the paper's CNN (:func:`repro_torch.models.cnn.loss_fn`).  The step's
noise seed is the step number (``Ctx.seed = step``), so technique A sees
fresh fluctuation data every batch and a resumed run draws what an
uninterrupted one would.  The state is ``{"params", "opt", "step"}`` with
JAX's tree paths and a 0-dim int32 ``step``, so checkpoints interchange.
The sharded step (``jit_train_step``, state shardings, the mesh) is
multi-device training, ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import cnn, lm
from repro_torch.models.context import Ctx
from repro_torch.nn.param import init_params
from repro_torch.train.optimizer import (Optimizer, OptimizerConfig,
                                         clip_by_global_norm, cosine_schedule)
from repro_torch.utils.pytrees import flatten_with_paths, unflatten_paths

MULTI_DEVICE = ("multi-device training (the mesh, shardings and "
                "jit_train_step) is ported with ROADMAP Queue 1 item 11")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lam: float = 1e-6                   # technique-B regularization weight
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    opt: OptimizerConfig = OptimizerConfig()


def _specs(cfg):
    return cnn.specs(cfg) if isinstance(cfg, cnn.CNNConfig) else lm.specs(cfg)


def state_from_params(params, opt: Optimizer) -> dict:
    """The train state at step 0 around `params` (made to require grad)."""
    for _, p in flatten_with_paths(params):
        p.requires_grad_(True)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def init_state(cfg, opt: Optimizer, seed: int, device="cuda") -> dict:
    """Parameters of `cfg` (a ModelConfig or a CNNConfig) from `seed` with
    the port's init, and zeroed optimizer state."""
    return state_from_params(init_params(_specs(cfg), seed, device), opt)


def make_grad_fn(cfg, lam: float):
    """grad_fn(params, batch, step) -> (loss, metrics, grads): the loss of
    `cfg`'s model at noise seed `step` and its gradient in every leaf (a
    tree like params; zeros where the loss does not reach a leaf, as JAX
    gives)."""
    loss_fn = cnn.loss_fn if isinstance(cfg, cnn.CNNConfig) else lm.train_loss

    def grad_fn(params, batch, step: int):
        flat = flatten_with_paths(params)
        loss, metrics = loss_fn(params, batch, cfg, Ctx(seed=int(step)),
                                lam=lam)
        grads = torch.autograd.grad(loss, [p for _, p in flat],
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for (_, p), g in zip(flat, grads)]
        return (loss.detach(), metrics,
                unflatten_paths(zip((n for n, _ in flat), grads)))
    return grad_fn


def make_train_step(cfg, tcfg: TrainConfig, mesh=None, rules=None, *,
                    schedule=None):
    """Returns (train_step, opt): train_step(state, batch) -> (state,
    metrics), loss -> backward -> clip -> schedule -> update.  `mesh` and
    `rules` (sharding) raise: one device only."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(MULTI_DEVICE)
    opt = Optimizer(tcfg.opt)
    if schedule is None:
        schedule = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
    grad_fn = make_grad_fn(cfg, tcfg.lam)

    def train_step(state, batch):
        step = int(state["step"])
        loss, metrics, grads = grad_fn(state["params"], batch, step)
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        lr = schedule(step)
        params, opt_state = opt.update(grads, state["opt"], state["params"],
                                       lr, step)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return {"params": params, "opt": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step, opt


def jit_train_step(*args, **kw):
    """The fully sharded step of the JAX package; not ported yet."""
    raise NotImplementedError(MULTI_DEVICE)
