"""EMT device model: random-telegraph-noise (RTN) read fluctuation + energy.

Port of :mod:`repro.core.device`.  A read of a cell storing ``w`` with
energy coefficient ``rho`` returns ``w * (1 + a_l * sigma_rel(rho))`` with
``sigma_rel(rho) = amplitude * intensity_scale / rho**beta``; the state
offsets ``a_l`` are normalized to zero mean and unit variance under the
state probabilities.  Energy: ``E_mac = e_mac * rho * |w| * x_level``, a
peripheral term per row read and a static term per tile activation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

INTENSITY_SCALE = {"weak": 0.5, "normal": 1.0, "strong": 2.0}


def _normalize_states(offsets: Tuple[float, ...], probs: Tuple[float, ...]):
    """Shift/scale state offsets so reads are unbiased with unit relative
    variance."""
    a = np.asarray(offsets, np.float64)
    p = np.asarray(probs, np.float64)
    p = p / p.sum()
    a = a - (p * a).sum()
    var = (p * a * a).sum()
    if var > 0:
        a = a / math.sqrt(var)
    return tuple(float(v) for v in a), tuple(float(v) for v in p)


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Parametric RTN model of one EMT technology corner."""
    amplitude: float = 0.08
    beta: float = 0.5
    intensity: str = "normal"
    state_offsets: Tuple[float, ...] = (-1.0, 1.0)
    state_probs: Tuple[float, ...] = (0.5, 0.5)
    e_mac: float = 0.05
    e_read: float = 0.4
    e_static: float = 0.0
    rho_min: float = 1e-3

    def __post_init__(self):
        a, p = _normalize_states(self.state_offsets, self.state_probs)
        object.__setattr__(self, "state_offsets", a)
        object.__setattr__(self, "state_probs", p)
        if len(a) != len(p):
            raise ValueError("state offsets/probs length mismatch")

    @property
    def num_states(self) -> int:
        return len(self.state_offsets)

    @property
    def intensity_scale(self) -> float:
        return INTENSITY_SCALE[self.intensity]

    def sigma_rel(self, rho: torch.Tensor) -> torch.Tensor:
        """Relative read std given the energy coefficient rho (float32)."""
        rho = torch.clamp_min(rho, self.rho_min)
        return self.amplitude * self.intensity_scale / torch.pow(rho, self.beta)

    def mac_energy(self, rho, abs_w_sum, x_level_mean, n_reads_per_cell):
        return self.e_mac * rho * abs_w_sum * x_level_mean * n_reads_per_cell

    def peripheral_energy(self, n_row_reads):
        return self.e_read * n_row_reads

    def static_energy(self, n_tile_activations):
        return self.e_static * n_tile_activations

    def with_intensity(self, intensity: str) -> "DeviceModel":
        return dataclasses.replace(self, intensity=intensity)


def four_state_device(**kw) -> DeviceModel:
    """A mildly multi-state (4-state RTN) corner."""
    return DeviceModel(state_offsets=(-1.5, -0.5, 0.5, 1.5),
                       state_probs=(0.15, 0.35, 0.35, 0.15), **kw)


DEFAULT_DEVICE = DeviceModel()

# Calibrated technology corners; the derivation is in docs/device_models.md.
_REGISTRY = {
    "default": DEFAULT_DEVICE,
    "pcm": DeviceModel(amplitude=0.08, beta=0.5, e_mac=0.0025,
                       e_read=200.0, e_static=4000.0),
    "rram": DeviceModel(amplitude=0.14, beta=0.4, e_mac=0.0015,
                        e_read=120.0, e_static=2400.0),
    "mlc2": DeviceModel(amplitude=0.10, beta=0.5, e_mac=0.003,
                        e_read=250.0, e_static=5000.0),
    "mlc4": four_state_device(amplitude=0.10, beta=0.5, e_mac=0.003,
                              e_read=250.0, e_static=5000.0),
    "sram_digital": DeviceModel(amplitude=0.0, beta=0.5, e_mac=0.0015,
                                e_read=10.0, e_static=0.0),
}


def register_device(name: str, model: DeviceModel,
                    overwrite: bool = False) -> DeviceModel:
    """Register a user-defined technology corner under `name`."""
    if not isinstance(model, DeviceModel):
        raise TypeError(f"expected DeviceModel, got {type(model).__name__}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"device corner {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[name] = model
    return model


def get_device(name: str) -> DeviceModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown device corner {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def device_names():
    return sorted(_REGISTRY)
