"""Deterministic synthetic data (port of :mod:`repro.data.synthetic`,
numpy only, so a batch is JAX's bit for bit).

* ``SyntheticLM``: learnable token streams, an affine Markov chain over the
  vocabulary with injected noise, deterministic in (seed, step, host), so a
  run resumes exactly from any checkpointed step.
* ``SyntheticImages``: class-conditional images for the paper's CNN
  experiments, per-class frequency patterns plus Gaussian noise.

Both draw with numpy and hand the batch over as tensors on ``device``
(the card by default).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _tensors(batch: dict, device) -> dict:
    from repro_torch import resolve_device
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int                  # per-host batch
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    input_kind: str = "tokens"       # tokens | embeds
    d_model: int = 0                 # for embeds stubs
    encdec: bool = False
    device: str = "cuda"

    def arrays_at(self, step: int) -> dict:
        """The batch of a global step as numpy arrays (JAX's batch_at)."""
        rng = np.random.default_rng((self.seed, step, self.host_id, 0xE17))
        V = self.vocab_size
        B, S = self.batch_size, self.seq_len
        a = 31 % V or 1
        b = rng.integers(0, V)
        x0 = rng.integers(0, V, size=(B, 1))
        toks = [x0]
        for _ in range(S):
            nxt = (toks[-1] * a + b) % V
            flip = rng.random((B, 1)) < 0.1
            nxt = np.where(flip, rng.integers(0, V, size=(B, 1)), nxt)
            toks.append(nxt)
        seq = np.concatenate(toks, axis=1).astype(np.int32)   # (B, S+1)
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if self.input_kind == "embeds":
            batch["embeds"] = rng.standard_normal(
                (B, S, self.d_model)).astype(np.float32)
        if self.encdec:
            batch["enc_embeds"] = rng.standard_normal(
                (B, S, self.d_model)).astype(np.float32)
        return batch

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (resume-safe), as tensors
        on ``self.device``."""
        return _tensors(self.arrays_at(step), self.device)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class SyntheticImages:
    num_classes: int = 4
    image_size: int = 16
    channels: int = 3
    noise: float = 0.25
    seed: int = 0
    device: str = "cuda"

    def _pattern(self, cls):
        """Per-class deterministic frequency pattern."""
        s = self.image_size
        yy, xx = np.mgrid[0:s, 0:s] / s
        freq = 1 + cls % 3
        phase = cls * 0.7
        base = np.sin(2 * np.pi * freq * xx + phase) * \
            np.cos(2 * np.pi * (1 + cls // 3) * yy)
        img = np.stack([base, base.T, base * base.T], -1)
        return 0.5 + 0.4 * img

    def arrays(self, batch_size: int, step: int, split: str = "train"):
        """The batch as numpy arrays (JAX's batch)."""
        salt = 0 if split == "train" else 0x7E57
        rng = np.random.default_rng((self.seed, step, salt))
        labels = rng.integers(0, self.num_classes, size=batch_size)
        imgs = np.stack([self._pattern(c) for c in labels]).astype(np.float32)
        imgs += rng.standard_normal(imgs.shape).astype(np.float32) * self.noise
        return {"images": np.clip(imgs, 0, 1),
                "labels": labels.astype(np.int32)}

    def batch(self, batch_size: int, step: int, split: str = "train"):
        """images (B, H, W, C) in [0, 1] and labels (B,), as tensors on
        ``self.device``."""
        return _tensors(self.arrays(batch_size, step, split), self.device)
