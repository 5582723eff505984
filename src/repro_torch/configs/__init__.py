"""Architecture registry of the port: the reference's ten architectures
(gemma3-1b, gemma2-9b, llama3-405b, deepseek-67b, qwen2-vl-72b,
llama4-scout-17b-a16e, seamless-m4t-medium, moonshot-v1-16b-a3b,
xlstm-350m, jamba-v0.1-52b).

    from repro_torch.configs import get_config
    cfg = get_config("gemma3-1b", emt_mode="analog")
    cfg = get_config("gemma3-1b", placement="mixed")
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_67b, gemma2_9b, gemma3_1b,
                                 jamba_v0_1_52b, llama3_405b,
                                 llama4_scout_17b_a16e, moonshot_v1_16b_a3b,
                                 qwen2_vl_72b, seamless_m4t_medium,
                                 xlstm_350m)
from repro_torch.configs.common import (PLACEMENTS, emt_preset,
                                        mixed_placement, placement_preset,
                                        shrink)

ARCHS = {"gemma3-1b": gemma3_1b,
         "gemma2-9b": gemma2_9b,
         "llama3-405b": llama3_405b,
         "deepseek-67b": deepseek_67b,
         "qwen2-vl-72b": qwen2_vl_72b,
         "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
         "seamless-m4t-medium": seamless_m4t_medium,
         "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
         "xlstm-350m": xlstm_350m,
         "jamba-v0.1-52b": jamba_v0_1_52b}

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
        raise KeyError(f"unknown architecture {name!r}; known: "
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
