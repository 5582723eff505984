"""Heterogeneous device placement: per-layer EMT technology corners (port of
:mod:`repro.core.placement`, with its dict serialization).

A model config may carry a :class:`DevicePlacement` instead of one global
``EMTConfig``: an ordered list of :class:`LayerRule` glob patterns over
canonical layer paths (``dec/layer_007/attn/wq``, ``dec/layer_007/mlp/wg``,
``unembed``, ...), resolved when the model is built.  Rules are
first-match-wins; unmatched paths take ``default``.  A plain ``EMTConfig``
wraps into a zero-rule placement (:func:`as_placement`).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import Callable, Optional, Tuple, Union

from repro_torch.core.device import DeviceModel, get_device
from repro_torch.core.emt_linear import EMTConfig, IDEAL
from repro_torch.core.noise import NoiseConfig
from repro_torch.core.quant import QuantConfig


def emt_for_corner(corner: str, mode: str = "analog", *,
                   intensity: str = "normal", rho_init: float = 4.0,
                   trainable_rho: Optional[bool] = None,
                   **kw) -> EMTConfig:
    """An EMTConfig on a registered technology corner.  ``mode="ideal"``
    gives a corner-labelled ideal config; unknown corners raise
    ``KeyError``."""
    device = get_device(corner)
    if mode == "ideal":
        return EMTConfig(mode="ideal", quant=QuantConfig(enabled=False),
                         device=device, corner=corner)
    if trainable_rho is None:
        # a deterministic (amplitude-0) digital corner has no trade-off for
        # rho gradients to navigate
        trainable_rho = device.amplitude > 0
    return EMTConfig(
        mode=mode,
        quant=QuantConfig(w_bits=8, a_bits=8, enabled=True),
        noise=NoiseConfig(backend="hash", granularity="per_step"),
        device=device.with_intensity(intensity),
        rho_init=rho_init,
        trainable_rho=trainable_rho,
        corner=corner,
        **kw)


@dataclasses.dataclass(frozen=True)
class LayerRule:
    """Glob `pattern` over canonical layer paths -> `emt` config."""
    pattern: str
    emt: EMTConfig

    def matches(self, path: str) -> bool:
        return fnmatch.fnmatchcase(path, self.pattern)


@dataclasses.dataclass(frozen=True)
class DevicePlacement:
    """Ordered first-match-wins rules + a default for unmatched paths."""
    rules: Tuple[LayerRule, ...] = ()
    default: EMTConfig = IDEAL

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        for r in self.rules:
            if not isinstance(r, LayerRule):
                raise TypeError(f"rules must be LayerRule, got "
                                f"{type(r).__name__}")

    def match(self, path: str) -> Optional[EMTConfig]:
        """First explicit rule matching `path`, or None (the default is not
        applied): for sites that stay digital unless placed."""
        for rule in self.rules:
            if rule.matches(path):
                return rule.emt
        return None

    def resolve(self, path: str) -> EMTConfig:
        """Per-layer config for `path`: first matching rule, else the
        default."""
        hit = self.match(path)
        return self.default if hit is None else hit

    @property
    def active(self) -> bool:
        return self.default.active or any(r.emt.active for r in self.rules)

    @property
    def mode(self) -> str:
        """Representative mode (the default's), for display only."""
        return self.default.mode

    def corners(self) -> Tuple[str, ...]:
        """All corner labels this placement can book energy under."""
        seen = []
        for emt in [r.emt for r in self.rules] + [self.default]:
            label = emt.corner_label
            if label not in seen:
                seen.append(label)
        return tuple(seen)


def single(emt: EMTConfig) -> DevicePlacement:
    """Wrap one global EMTConfig as a zero-rule placement."""
    return DevicePlacement(rules=(), default=emt)


@functools.lru_cache(maxsize=None)
def _coerce(emt) -> DevicePlacement:
    return emt if isinstance(emt, DevicePlacement) else single(emt)


def as_placement(emt: Union[EMTConfig, DevicePlacement]) -> DevicePlacement:
    """Normalize an `emt` field (EMTConfig or DevicePlacement) to a
    placement."""
    if not isinstance(emt, (EMTConfig, DevicePlacement)):
        raise TypeError(f"emt must be EMTConfig or DevicePlacement, "
                        f"got {type(emt).__name__}")
    return _coerce(emt)


# ---------------------------------------------------------------------------
# dict serialization (checkpoint ``extra`` metadata), JSON-compatible with
# JAX's: the same keys and values, but for EMTConfig's two TPU kernel
# switches, which the port has not (it dispatches on the tensors' device)
# and drops when it reads a JAX dict
# ---------------------------------------------------------------------------
TPU_ONLY_EMT_KEYS = ("use_pallas", "pallas_interpret")


def device_to_dict(dev: DeviceModel) -> dict:
    return {f.name: getattr(dev, f.name)
            for f in dataclasses.fields(DeviceModel)}


def device_from_dict(d: dict) -> DeviceModel:
    known = {f.name for f in dataclasses.fields(DeviceModel)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown DeviceModel fields {sorted(unknown)}")
    d = dict(d)
    for k in ("state_offsets", "state_probs"):
        if k in d:
            d[k] = tuple(d[k])
    return DeviceModel(**d)


def emt_to_dict(emt: EMTConfig) -> dict:
    d = {f.name: getattr(emt, f.name) for f in dataclasses.fields(EMTConfig)}
    d["quant"] = dataclasses.asdict(emt.quant)
    d["noise"] = dataclasses.asdict(emt.noise)
    d["device"] = device_to_dict(emt.device)
    return d


def emt_from_dict(d: dict) -> EMTConfig:
    d = {k: v for k, v in d.items() if k not in TPU_ONLY_EMT_KEYS}
    if "quant" in d:
        d["quant"] = QuantConfig(**d["quant"])
    if "noise" in d:
        d["noise"] = NoiseConfig(**d["noise"])
    if "device" in d:
        dev = d["device"]
        # a string names a registered corner (KeyError if unknown); a dict
        # carries the full parameters inline
        d["device"] = (get_device(dev) if isinstance(dev, str)
                       else device_from_dict(dev))
    return EMTConfig(**d)


def placement_to_dict(p: Union[EMTConfig, DevicePlacement]) -> dict:
    p = as_placement(p)
    return {"rules": [{"pattern": r.pattern, "emt": emt_to_dict(r.emt)}
                      for r in p.rules],
            "default": emt_to_dict(p.default)}


def placement_from_dict(d: dict) -> DevicePlacement:
    rules = tuple(LayerRule(r["pattern"], emt_from_dict(r["emt"]))
                  for r in d.get("rules", ()))
    return DevicePlacement(rules=rules, default=emt_from_dict(d["default"]))


def map_corners(emt: Union[EMTConfig, DevicePlacement],
                fn: Callable[[EMTConfig], EMTConfig]):
    """`fn` applied to every corner's config: to a placement's rules and
    default, or to a single EMTConfig."""
    if isinstance(emt, DevicePlacement):
        return dataclasses.replace(
            emt, rules=tuple(LayerRule(r.pattern, fn(r.emt))
                             for r in emt.rules),
            default=fn(emt.default))
    return fn(emt)
