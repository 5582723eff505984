"""PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

Mirrors the JAX package's module layout (``repro_torch.core.hashrng`` <->
``repro.core.hashrng`` and so on) and imports neither ``jax`` nor ``repro``.
Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on; raises when CUDA is asked
    for and no card is present (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch path on the CPU")
    return dev
