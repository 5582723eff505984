"""Architecture registry of the port (gemma3-1b, seamless-m4t-medium).

    from repro_torch.configs import get_config
    cfg = get_config("gemma3-1b", emt_mode="analog")
    cfg = get_config("gemma3-1b", placement="mixed")
"""
from __future__ import annotations

from repro_torch.configs import gemma3_1b, seamless_m4t_medium
from repro_torch.configs.common import (PLACEMENTS, emt_preset,
                                        mixed_placement, placement_preset,
                                        shrink)

ARCHS = {"gemma3-1b": gemma3_1b,
         "seamless-m4t-medium": seamless_m4t_medium}

__all__ = ["ARCHS", "PLACEMENTS", "emt_preset", "get_config",
           "mixed_placement", "placement_preset", "shrink"]


def get_config(name: str, *, emt_mode: str = None, rng: str = "hash",
               intensity: str = None, smoke: bool = False, placement=None,
               **emt_kw):
    """Model config of a registered architecture.  `placement` (a
    DevicePlacement, an EMTConfig or a preset name from PLACEMENTS)
    replaces the single-corner emt_* preset; passing an explicit emt knob
    beside it is an error, not a silent override."""
    if name not in ARCHS:
        raise KeyError(f"architecture {name!r} is not ported yet; ported: "
                       f"{sorted(ARCHS)}")
    if placement is not None:
        knobs = dict(emt_mode=emt_mode, intensity=intensity, **emt_kw)
        conflict = sorted(k for k, v in knobs.items() if v is not None)
        if conflict:
            raise ValueError(f"placement= overrides per-corner EMT settings; "
                             f"drop {conflict}")
        emt = placement_preset(placement, rng=rng) \
            if isinstance(placement, str) else placement
    else:
        emt = emt_preset(emt_mode or "analog", rng=rng,
                         intensity=intensity or "normal", **emt_kw)
    mod = ARCHS[name]
    return mod.smoke(emt) if smoke else mod.build(emt)
