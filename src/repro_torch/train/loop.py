"""Fault-tolerant training loop (port of :mod:`repro.train.loop`).

* auto-resume from the latest valid checkpoint,
* periodic and SIGTERM-triggered (preemption) checkpoints, async by
  default,
* straggler watchdog: a per-step wall-time EWMA; steps slower than
  ``straggler_factor x`` the EWMA are reported through a pluggable hook,
* metrics streamed to JSONL.

A step's time ends in ``torch.cuda.synchronize()`` when the state lives on
the card (PyTorch returns before the device finishes).  The last step is
saved once: JAX's loop saves it again after the loop; here the final save
only waits for the one in flight when that step was just saved.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import tempfile
import threading
import time
from typing import Callable, Optional

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.utils.pytrees import flatten_with_paths


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 200
    ckpt_every: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    log_every: int = 10
    metrics_path: Optional[str] = None
    straggler_factor: float = 3.0


def _on_card(state) -> bool:
    return any(t.is_cuda for _, t in flatten_with_paths(state["params"]))


def train_loop(state, train_step: Callable,
               data_iter_at: Callable[[int], dict], cfg: LoopConfig, *,
               straggler_hook: Callable = None, log=print):
    """Run to cfg.total_steps with checkpoint/restart and watchdog.

    data_iter_at(step) must return the batch for that step (deterministic
    pipelines make restarts exact).  Returns (state, history list of
    metrics)."""
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
    restored, meta = mgr.restore_latest(state)
    if restored is not None:
        state = restored
        log(f"[loop] resumed from step {meta['step']}")
    sync = torch.cuda.synchronize if _on_card(state) else (lambda: None)

    stop = {"flag": False}

    def on_term(signum, frame):
        stop["flag"] = True
        log("[loop] SIGTERM — checkpointing and exiting")
    main = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, on_term) if main else None

    history = []
    ewma = None
    saved = None
    try:
        step = int(state["step"])
        while step < cfg.total_steps and not stop["flag"]:
            batch = data_iter_at(step)
            sync()
            t0 = time.time()
            state, metrics = train_step(state, batch)
            sync()
            dt = time.time() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > cfg.straggler_factor * ewma and step > 5:
                msg = (f"[watchdog] step {step} took {dt:.3f}s "
                       f"(ewma {ewma:.3f}s)")
                (straggler_hook or log)(msg)
            step += 1
            if step % cfg.log_every == 0 or step == cfg.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["step_time_s"] = dt
                history.append(m)
                log(f"[step {step:5d}] " + " ".join(
                    f"{k}={v:.4g}" for k, v in m.items() if k != "step"))
                if cfg.metrics_path:
                    with open(cfg.metrics_path, "a") as f:
                        f.write(json.dumps(m) + "\n")
            if step % cfg.ckpt_every == 0 or stop["flag"] or \
                    step == cfg.total_steps:
                mgr.save(step, state)
                saved = step
        final = int(state["step"])
        if saved != final:
            mgr.save(final, state, block=True)
    finally:
        mgr.wait()
        if main:
            signal.signal(signal.SIGTERM, old)
    return state, history
