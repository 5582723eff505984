"""EMT dense layer: the paper's techniques A/B/C as a drop-in matmul.

Port of :mod:`repro.core.emt_linear` for the ``ideal``, ``analog`` and
``bitserial`` modes.  Every call returns ``(y, aux)``: aux carries the
technique-B regularization term, the analytic energy estimate in pJ, and
read/cell counts, summed up the model with :func:`add_aux`.  In analog mode
the noisy product goes through the fused technique-A kernel
(``kernels/emt_matmul.py``), which computes the same arithmetic as JAX's
``fluctuate`` + ``@`` without a weight-sized noise tensor; in bitserial mode
through the technique-C kernel (``kernels/emt_bitserial.py``), JAX's
``decompose.bitserial_matmul_ref``.

Scalar aux entries start as Python floats and become float32 tensors on the
model's device as layers add into them, so accounting needs no host sync.
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch

from repro_torch.core import regularizer
from repro_torch.core.decompose import popcount_levels
from repro_torch.core.device import DEFAULT_DEVICE, DeviceModel
from repro_torch.core.noise import NoiseConfig
from repro_torch.core.quant import QuantConfig, quant_levels, quantize_weights
from repro_torch.nn.param import ParamSpec, constant_init, fan_in_init

_LATER = "a later slice of the port (ROADMAP Queue 1/2)"


@dataclasses.dataclass(frozen=True)
class EMTConfig:
    """How EMT simulation applies to the model's dense layers."""
    mode: str = "ideal"                      # ideal | analog | bitserial
    quant: QuantConfig = QuantConfig()
    noise: NoiseConfig = NoiseConfig()
    device: DeviceModel = DEFAULT_DEVICE
    rho_init: float = 4.0
    trainable_rho: bool = True
    crossbar_tile: int = 128
    energy_accounting: str = "full"          # full | off
    store_int8: bool = False
    corner: str = ""

    def __post_init__(self):
        if self.mode not in ("ideal", "analog", "bitserial"):
            raise ValueError(f"unknown EMT mode {self.mode!r}")
        if self.store_int8:
            raise NotImplementedError("store_int8 weights are ported with "
                                      + _LATER)

    @property
    def active(self) -> bool:
        return self.mode != "ideal"

    @property
    def corner_label(self) -> str:
        return self.corner or self.mode

    def replace(self, **kw) -> "EMTConfig":
        return dataclasses.replace(self, **kw)


IDEAL = EMTConfig(mode="ideal", quant=QuantConfig(enabled=False))


def _tag_plane(tag: str) -> int:
    """Stable per-layer noise plane derived from the layer's name."""
    return zlib.crc32(tag.encode()) & 0x7FFFFFF


def dense_specs(d_in: int, d_out: int, cfg: EMTConfig, *,
                dtype=torch.float32, bias: bool = False, init=None) -> dict:
    """ParamSpec dict for one EMT dense layer (w [, b] [, rho_raw])."""
    specs = {"w": ParamSpec((d_in, d_out), dtype,
                            init or fan_in_init(fan_axis=0))}
    if bias:
        specs["b"] = ParamSpec((d_out,), dtype, constant_init(0.0))
    if cfg.active:
        specs["rho_raw"] = ParamSpec(
            (), torch.float32,
            constant_init(regularizer.rho_init_raw(cfg.rho_init)))
    return specs


def new_aux():
    return {"energy_pj": 0.0, "reg": 0.0, "reads": 0.0, "kv_reads": 0.0,
            "cells": 0, "rho_sum": 0.0, "rho_layers": 0, "aux_loss": 0.0,
            "corners": {}}


def corner_entry(energy_pj, reads, cells):
    return {"energy_pj": energy_pj, "reads": reads, "cells": cells}


def add_aux(a, b):
    out = {k: a[k] + b[k] for k in a if k != "corners"}
    corners = {k: dict(v) for k, v in a.get("corners", {}).items()}
    for name, c in b.get("corners", {}).items():
        if name in corners:
            corners[name] = {k: corners[name][k] + c[k] for k in c}
        else:
            corners[name] = dict(c)
    out["corners"] = corners
    return out


def emt_dense(params: dict, x: torch.Tensor, cfg: EMTConfig, *, tag: str,
              seed: int = 0):
    """Apply the layer. Returns (y, aux).

    tag:  unique layer name; crc32(tag) is the layer's noise plane, so tags
          must equal the JAX package's ("dec/layer_000/attn/wq", "unembed").
    seed: the step's noise seed (a Python int).
    """
    from repro_torch.kernels import ops     # kernels depend on core

    w = params["w"]
    aux = new_aux()
    d_in, d_out = w.shape
    plane = _tag_plane(tag)

    if not cfg.active:
        y = x @ w
        if "b" in params:
            y = y + params["b"]
        return y, aux

    rho = regularizer.rho_from_raw(params["rho_raw"])
    if not cfg.trainable_rho:
        rho = rho.detach()
    wq, _ = quantize_weights(w, cfg.quant)
    a_axis = -1 if cfg.quant.a_per_row else None
    levels, a_scale = quant_levels(x, cfg.quant.a_bits, axis=a_axis)
    n_tokens = math.prod(x.shape[:-1])

    if cfg.mode == "analog":
        xin = levels * a_scale
        if not cfg.noise.enabled:
            y = xin @ wq
        elif cfg.noise.backend != "hash":
            raise NotImplementedError(
                f"noise backend {cfg.noise.backend!r} is ported with "
                + _LATER)
        else:
            y = ops.emt_matmul(xin, wq, cfg.device.sigma_rel(rho),
                               device=cfg.device, seed=seed, plane=plane)
        # mean input level in LEVEL units, comparable with Eq. 19's popcount
        x_level = torch.mean(torch.abs(levels)).detach()
    else:
        # bitserial: one crossbar read per activation bit-plane, each with
        # its own hash noise (as JAX, whatever cfg.noise says); energy counts
        # the bit reads actually made (Eq. 19)
        bits = cfg.quant.a_bits - 1
        y = ops.emt_bitserial_matmul(levels, wq, cfg.device.sigma_rel(rho),
                                     device=cfg.device, bits=bits, seed=seed,
                                     base_plane=plane) * a_scale
        x_level = torch.mean(popcount_levels(torch.abs(levels), bits)
                             ).detach()
    reads_per_cell = float(n_tokens)

    if "b" in params:
        y = y + params["b"]

    if cfg.energy_accounting == "off":
        aux["cells"] = int(d_in * d_out)
        aux["corners"] = {cfg.corner_label: corner_entry(0.0, 0.0,
                                                         aux["cells"])}
        return y, aux

    wabs = torch.abs(wq.to(torch.float32))
    w_norm = (torch.sum(wabs) / torch.clamp_min(torch.amax(wabs), 1e-8)
              ).detach()
    rho_sg = rho.detach()
    n_tiles = (d_in / cfg.crossbar_tile) * max(1.0, d_out / cfg.crossbar_tile)
    energy = (cfg.device.mac_energy(rho_sg, w_norm, x_level, reads_per_cell)
              + cfg.device.peripheral_energy(n_tokens * n_tiles)
              + cfg.device.static_energy(n_tiles))
    aux["energy_pj"] = energy.to(torch.float32)
    aux["reg"] = regularizer.layer_reg_term(wq, rho, alpha=1.0) / d_out
    aux["reads"] = float(np.float32(n_tokens * d_in))
    aux["cells"] = int(d_in * d_out)
    aux["rho_sum"] = rho_sg
    aux["rho_layers"] = 1
    aux["corners"] = {cfg.corner_label: corner_entry(
        aux["energy_pj"], aux["reads"], aux["cells"])}
    return y, aux
