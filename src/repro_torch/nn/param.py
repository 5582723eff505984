"""Parameter specs, the port's seeded init, and the numpy weight bridge.

Port of :mod:`repro.nn.param` without the sharding half (the port runs on
one card).  Model modules declare parameters as nested dicts of
:class:`ParamSpec`; :func:`init_params` materializes them from a seed with a
``torch.Generator`` on the target device, and :func:`load_arrays` builds the
same tree from a by-path numpy dict (the format
``repro/ckpt/checkpoint.py::_tree_to_arrays`` writes), so a test can hold the
port to the JAX package on identical weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.utils.pytrees import flatten_with_paths, unflatten_paths

Initializer = Callable[[torch.Generator, Sequence[int], Any, torch.device],
                       torch.Tensor]


def ones_init(gen, shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


def constant_init(value: float) -> Initializer:
    def init(gen, shape, dtype, device):
        return torch.full(shape, value, dtype=dtype, device=device)
    return init


def normal_init(stddev: float = 0.02) -> Initializer:
    def init(gen, shape, dtype, device):
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * stddev).to(dtype)
    return init


def fan_in_init(scale: float = 1.0, fan_axis: int = -2) -> Initializer:
    """LeCun-style: stddev = scale / sqrt(fan_in)."""
    def init(gen, shape, dtype, device):
        fan_in = shape[fan_axis] if len(shape) >= 2 else shape[0]
        std = scale / np.sqrt(max(1, fan_in))
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)
    return init


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""
    shape: tuple
    dtype: Any = torch.float32
    init: Initializer = dataclasses.field(default=normal_init())


def init_params(specs, seed: int, device="cuda"):
    """Materialize a spec tree from `seed` on `device` (deterministic per
    seed and device; the numbers differ from JAX's, which the bridge below
    carries across when a test needs identical weights)."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return unflatten_paths(
        (path, s.init(gen, tuple(s.shape), s.dtype, dev))
        for path, s in flatten_with_paths(specs))


def load_arrays(specs, arrays: dict, device="cuda"):
    """Build the parameter tree for `specs` from a by-path numpy dict.

    Raises KeyError for a missing or unexpected path and ValueError for a
    shape mismatch."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    flat = flatten_with_paths(specs)
    unknown = sorted(set(arrays) - {p for p, _ in flat})
    if unknown:
        raise KeyError(f"arrays hold paths the model does not: {unknown}")
    out = []
    for path, s in flat:
        if path not in arrays:
            raise KeyError(f"arrays missing tensor {path!r}")
        arr = np.asarray(arrays[path])
        if tuple(arr.shape) != tuple(s.shape):
            raise ValueError(f"{path}: array shape {arr.shape} != expected "
                             f"{tuple(s.shape)}")
        out.append((path, torch.from_numpy(np.array(arr)).to(
            device=dev, dtype=s.dtype)))
    return unflatten_paths(out)
