"""EMT dense layer: the paper's techniques A/B/C as a drop-in matmul.

Port of :mod:`repro.core.emt_linear` for the ``ideal``, ``analog`` and
``bitserial`` modes.  Every call returns ``(y, aux)``: aux carries the
technique-B regularization term, the analytic energy estimate in pJ, and
read/cell counts, summed up the model with :func:`add_aux`.  In analog mode
the noisy product goes through the fused technique-A kernel
(``kernels/emt_matmul.py``), which computes the same arithmetic as JAX's
``fluctuate`` + ``@`` without a weight-sized noise tensor (the threefry
backend materializes its noise, as JAX does, and multiplies with
``torch.matmul``); in bitserial mode through the technique-C kernel
(``kernels/emt_bitserial.py``), JAX's ``decompose.bitserial_matmul_ref``.

int8 weight streaming (``store_int8``, serve-only): a layer may hold its
weight as int8 conductance levels ``w_int8`` and a per-column float32
``w_scale`` (:func:`dense_specs` with ``store_int8``, or
:func:`quantize_tree_for_serving` of a float tree).  ``emt_dense`` takes
that form whenever the params hold ``w_int8``, whatever the config says;
the analog kernel reads the levels and dequantizes them in registers, and
the accounting's |w| sum and max come from the levels' exact int32 column
sums and maxima times the scale, so that path never builds the float32
weight.  The bit-serial and threefry paths dequantize in PyTorch, as JAX
does.

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
from repro_torch.core.noise import NoiseConfig, fluctuate, fold_in
from repro_torch.core.quant import QuantConfig, quant_levels, quantize_weights
from repro_torch.nn.param import ParamSpec, constant_init, fan_in_init


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
    # serve-only: an active layer stores its weight as int8 conductance
    # levels + a per-column float32 scale (dense_specs)
    store_int8: bool = False
    corner: str = ""

    def __post_init__(self):
        if self.mode not in ("ideal", "analog", "bitserial"):
            raise ValueError(f"unknown EMT mode {self.mode!r}")

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


def _int8_levels(w: torch.Tensor):
    """(levels, scale) of a float weight: scale = max|w| / 127 over axis 0
    (1, d_out) and levels = clip(round(w / max(scale, 1e-8)), -127, 127) as
    int8, each step rounded in float32 as JAX rounds it."""
    w = w.to(torch.float32)
    scale = torch.amax(torch.abs(w), dim=0, keepdim=True) / 127.0
    q = torch.clamp(torch.round(w / torch.clamp_min(scale, 1e-8)), -127, 127)
    return q.to(torch.int8), scale


def _int8_init(base_init):
    """Initialize int8 conductance levels by quantizing a float init."""
    def init(gen, shape, dtype, device):
        return _int8_levels(base_init(gen, shape, torch.float32, device))[0]
    return init


def dense_specs(d_in: int, d_out: int, cfg: EMTConfig, *,
                dtype=torch.float32, bias: bool = False, init=None) -> dict:
    """ParamSpec dict for one EMT dense layer (w [, b] [, rho_raw]).

    With ``cfg.store_int8`` on an active layer, ``w`` is stored as
    ``w_int8`` (int8 levels, the float init quantized) and ``w_scale``
    (1, d_out) float32.  As in JAX, ``w_scale`` initializes to the constant
    1/127, not the scale the levels were quantized with, so a freshly
    initialized int8 model has other weights than the float one."""
    base_init = init or fan_in_init(fan_axis=0)
    if cfg.active and cfg.store_int8:
        specs = {"w_int8": ParamSpec((d_in, d_out), torch.int8,
                                     _int8_init(base_init)),
                 "w_scale": ParamSpec((1, d_out), torch.float32,
                                      constant_init(1.0 / 127.0))}
    else:
        specs = {"w": ParamSpec((d_in, d_out), dtype, base_init)}
    if bias:
        specs["b"] = ParamSpec((d_out,), dtype, constant_init(0.0))
    if cfg.active:
        specs["rho_raw"] = ParamSpec(
            (), torch.float32,
            constant_init(regularizer.rho_init_raw(cfg.rho_init)))
    return specs


def quantize_tree_for_serving(params):
    """A trained float tree in int8 weight-streaming form: every dict
    holding ``w`` and ``rho_raw`` gets ``w_int8`` and ``w_scale`` in place
    of ``w`` (bit-equal to JAX's ``quantize_tree_for_serving``); every
    other leaf is kept (the tied unembed, whose dict holds no ``w``, stays
    float)."""
    if isinstance(params, dict):
        if "w" in params and "rho_raw" in params:
            q, scale = _int8_levels(params["w"])
            out = {k: v for k, v in params.items() if k != "w"}
            out["w_int8"] = q
            out["w_scale"] = scale
            return out
        return {k: quantize_tree_for_serving(v) for k, v in params.items()}
    return params


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
              seed: int = 0, key=None):
    """Apply the layer. Returns (y, aux).

    tag:  unique layer name; crc32(tag) is the layer's noise plane, so tags
          must equal the JAX package's ("dec/layer_000/attn/wq", "unembed").
    seed: the step's noise seed (a Python int).
    key:  the threefry backend's torch.Generator; the layer draws from a
          generator derived from it and the plane (JAX's fold_in).
    """
    from repro_torch.kernels import ops     # kernels depend on core

    int8_weights = "w_int8" in params
    w = params["w_int8"] if int8_weights else params["w"]
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
    if int8_weights:
        # the stored conductance levels; K3 reads them itself, the other
        # paths take their float32 value, rounded once
        w_scale = params["w_scale"]
        in_kernel = (cfg.mode == "analog" and cfg.noise.enabled
                     and cfg.noise.backend == "hash")
        wq = None if in_kernel else w.to(x.dtype) * w_scale.to(x.dtype)
    else:
        wq, _ = quantize_weights(w, cfg.quant)
    a_axis = -1 if cfg.quant.a_per_row else None
    levels, a_scale = quant_levels(x, cfg.quant.a_bits, axis=a_axis)
    n_tokens = math.prod(x.shape[:-1])

    if cfg.mode == "analog":
        xin = levels * a_scale
        if not cfg.noise.enabled:
            y = xin @ wq
        elif cfg.noise.backend == "threefry":
            layer_key = (None if key is None
                         else fold_in(key, plane, device=wq.device))
            y = xin @ fluctuate(wq, rho, cfg.device, cfg.noise,
                                key=layer_key)
        elif cfg.noise.backend != "hash":
            raise ValueError(f"unknown noise backend {cfg.noise.backend!r}")
        else:
            y = ops.emt_matmul(xin, (w, w_scale) if int8_weights else wq,
                               cfg.device.sigma_rel(rho), device=cfg.device,
                               seed=seed, plane=plane)
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

    if wq is None:
        # |q * s| = |q| |s|: per column an exact int32 sum and max of the
        # levels, each scaled once (the max equal to JAX's, the sum within
        # float32 rounding of its sum of rounded products)
        qabs = torch.abs(w)
        s = torch.abs(w_scale.reshape(-1).to(torch.float32))
        w_abs_sum = torch.sum(
            torch.sum(qabs, dim=0, dtype=torch.int32).to(torch.float32) * s)
        w_abs_max = torch.amax(torch.amax(qabs, dim=0).to(torch.float32) * s)
    else:
        wabs = torch.abs(wq.to(torch.float32))
        w_abs_sum, w_abs_max = torch.sum(wabs), torch.amax(wabs)
    w_norm = (w_abs_sum / torch.clamp_min(w_abs_max, 1e-8)).detach()
    rho_sg = rho.detach()
    n_tiles = (d_in / cfg.crossbar_tile) * max(1.0, d_out / cfg.crossbar_tile)
    energy = (cfg.device.mac_energy(rho_sg, w_norm, x_level, reads_per_cell)
              + cfg.device.peripheral_energy(n_tokens * n_tiles)
              + cfg.device.static_energy(n_tiles))
    aux["energy_pj"] = energy.to(torch.float32)
    aux["reg"] = (rho * w_abs_sum if wq is None else
                  regularizer.layer_reg_term(wq, rho, alpha=1.0)) / d_out
    aux["reads"] = float(np.float32(n_tokens * d_in))
    aux["cells"] = int(d_in * d_out)
    aux["rho_sum"] = rho_sg
    aux["rho_layers"] = 1
    aux["corners"] = {cfg.corner_label: corner_entry(
        aux["energy_pj"], aux["reads"], aux["cells"])}
    return y, aux
