"""Training launcher of the port (port of :mod:`repro.launch.train`).

    python -m repro_torch.launch.train --arch gemma3-1b --steps 3
    python -m repro_torch.launch.train --arch gemma3-1b --smoke --steps 50

Trains a language model of the port (float32: the noisy-matmul kernels
take float32) on ``SyntheticLM`` through the fault-tolerant loop
(auto-resume, async checkpoints in the JAX package's format, SIGTERM-safe,
straggler watchdog, JSONL metrics).  It takes the JAX launcher's flags
(``--device`` names the EMT technology corner, as there).  The command
line runs on the card; a program passes ``main(argv, torch_device="cpu")``
to run the plain PyTorch path on the CPU.  ``--rng threefry`` fails at
the first analog projection with the reference's own ValueError ("threefry
backend needs a PRNG key"): JAX's train step never sets ``ctx.key``
(``repro/train/step.py:74``), and the port's step mirrors it.  Sharding
over more than one device (``--rules``, ROADMAP Queue 1 item 11) raises as
not yet ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, PLACEMENTS, get_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import (MULTI_DEVICE, TrainConfig, init_state,
                                    make_train_step)

# the JAX package's sharding rule names (repro/parallel/sharding.py RULES)
RULES = ("train_fsdp_tp", "train_fsdp_tp_sp", "train_dp", "serve_2d",
         "serve_longctx")


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lam", type=float, default=1e-6)
    ap.add_argument("--emt-mode", default="analog",
                    choices=["ideal", "analog", "bitserial"])
    ap.add_argument("--device", default=None,
                    help="registered technology corner for all layers")
    ap.add_argument("--placement", default=None, choices=PLACEMENTS,
                    help="heterogeneous per-layer placement preset "
                         "(overrides --emt-mode/--device)")
    ap.add_argument("--rng", default="hash", choices=["hash", "threefry"])
    ap.add_argument("--rules", default="train_fsdp_tp", choices=RULES)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--opt", default="adamw",
                    choices=["adamw", "sgd", "adafactor"])
    return ap


@dataclasses.dataclass
class Run:
    """What main() trains: the config, the train step, the state at step
    0, the data and the loop's config."""
    cfg: object
    tcfg: TrainConfig
    train_step: object
    state: dict
    data: SyntheticLM
    loop: LoopConfig


def setup(argv=None, *, torch_device="cuda", seed: int = 0) -> Run:
    """Parse `argv` as the command line does and build the run on
    `torch_device`, weights from `seed` (the port's init)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.placement and args.device:
        ap.error("--placement and --device are mutually exclusive "
                 "(a placement names its corners per layer)")
    dev = resolve_device(torch_device)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"--rules {args.rules} over {torch.cuda.device_count()} devices: "
            + MULTI_DEVICE)
    if args.placement:
        cfg = get_config(args.arch, rng=args.rng, smoke=args.smoke,
                         placement=args.placement)
        from repro_torch.launch.serve import print_plan
        print_plan(cfg)
    else:
        cfg = get_config(args.arch, emt_mode=args.emt_mode, rng=args.rng,
                         smoke=args.smoke, device=args.device)
    cfg = cfg.replace(dtype=torch.float32)
    tcfg = TrainConfig(lam=args.lam, lr=args.lr, total_steps=args.steps,
                       opt=OptimizerConfig(name=args.opt))
    train_step, opt = make_train_step(cfg, tcfg)
    state = init_state(cfg, opt, seed, device=dev)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       batch_size=args.batch, d_model=cfg.d_model,
                       input_kind=cfg.input_kind, encdec=cfg.is_encdec,
                       device=dev)
    loop = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir,
                      metrics_path=os.path.join(args.ckpt_dir,
                                                "metrics.jsonl"))
    return Run(cfg, tcfg, train_step, state, data, loop)


def main(argv=None, *, torch_device="cuda"):
    run = setup(argv, torch_device=torch_device)
    os.makedirs(run.loop.ckpt_dir, exist_ok=True)
    state, history = train_loop(run.state, run.train_step, run.data.batch_at,
                                run.loop)
    if history:
        print(f"final: {history[-1]}")
    return state, history


if __name__ == "__main__":
    main()
