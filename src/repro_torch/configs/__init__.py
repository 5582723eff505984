"""Architecture registry of the port (gemma3-1b in this slice).

    from repro_torch.configs import get_config
    cfg = get_config("gemma3-1b", emt_mode="analog")
"""
from __future__ import annotations

from repro_torch.configs import gemma3_1b
from repro_torch.configs.common import emt_preset, shrink

ARCHS = {"gemma3-1b": gemma3_1b}

__all__ = ["ARCHS", "emt_preset", "get_config", "shrink"]


def get_config(name: str, *, emt_mode: str = None, rng: str = "hash",
               intensity: str = None, smoke: bool = False, **emt_kw):
    """Model config of a registered architecture with one EMT corner."""
    if name not in ARCHS:
        raise KeyError(f"architecture {name!r} is not ported yet; ported: "
                       f"{sorted(ARCHS)}")
    emt = emt_preset(emt_mode or "analog", rng=rng,
                     intensity=intensity or "normal", **emt_kw)
    mod = ARCHS[name]
    return mod.smoke(emt) if smoke else mod.build(emt)
