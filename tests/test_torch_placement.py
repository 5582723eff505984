"""Port parity: per-layer device placement (rules, presets, config
resolution) against the JAX package, on the dense cases of
tests/test_placement.py.  Everything compared here is exact: resolved
corners and modes, plans, and the fields of the resolved configs.
"""
import dataclasses

import pytest
import torch

from repro.configs import PLACEMENTS as J_PLACEMENTS
from repro.configs import get_config as j_get_config
from repro.configs.common import emt_preset as j_emt_preset
from repro.configs.common import mixed_placement as j_mixed
from repro.core.emt_linear import IDEAL as J_IDEAL
from repro.core.placement import DevicePlacement as JPlacement
from repro.core.placement import LayerRule as JRule
from repro.core.placement import as_placement as j_as_placement
from repro.core.placement import emt_for_corner as j_corner
from repro.core.placement import single as j_single
from repro.serve.spec import ServeSpec
from repro_torch.configs import PLACEMENTS as T_PLACEMENTS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.common import emt_preset as t_emt_preset
from repro_torch.configs.common import mixed_placement as t_mixed
from repro_torch.core.emt_linear import IDEAL as T_IDEAL
from repro_torch.core.placement import DevicePlacement as TPlacement
from repro_torch.core.placement import LayerRule as TRule
from repro_torch.core.placement import as_placement as t_as_placement
from repro_torch.core.placement import emt_for_corner as t_corner
from repro_torch.core.placement import single as t_single
from repro_torch.serve.spec import build_config

PATHS = ("dec/layer_000/attn/wq", "dec/layer_000/attn/wk",
         "dec/layer_003/attn/wo", "dec/layer_000/mlp/wg",
         "dec/layer_012/mlp/wd", "dec/layer_001/xattn/wv",
         "dec/layer_002/moe/experts", "dec/layer_002/moe/router", "unembed")


def _fields(emt):
    """Every field of an EMTConfig as plain values (the two packages'
    dataclasses are different types)."""
    d = {f.name: getattr(emt, f.name) for f in dataclasses.fields(emt)
         if f.name not in ("use_pallas", "pallas_interpret")}
    for k in ("quant", "noise", "device"):
        d[k] = dataclasses.asdict(d[k])
    return d


def _label(emt):
    return None if emt is None else (emt.corner_label, emt.mode)


@pytest.mark.parametrize("corner,mode", [("pcm", "analog"),
                                         ("rram", "bitserial"),
                                         ("sram_digital", "analog"),
                                         ("mlc4", "analog"), ("pcm", "ideal")])
def test_emt_for_corner_matches_jax(corner, mode):
    assert _fields(t_corner(corner, mode)) == _fields(j_corner(corner, mode))
    assert _fields(t_corner(corner, mode, intensity="strong")) == \
        _fields(j_corner(corner, mode, intensity="strong"))


def test_unknown_corner_raises():
    with pytest.raises(KeyError, match="unknown device corner"):
        t_corner("vaporware")


def _both(rules, default):
    """The same rule list as a JAX and a port placement."""
    j = JPlacement(rules=tuple(JRule(p, j_corner(c, m)) for p, c, m in rules),
                   default=default[0])
    t = TPlacement(rules=tuple(TRule(p, t_corner(c, m)) for p, c, m in rules),
                   default=default[1])
    return j, t


@pytest.mark.parametrize("order", ["specific_first", "broad_first"])
def test_first_match_wins_on_overlapping_rules(order):
    rules = [("*/attn/wq", "pcm", "analog"), ("*/attn/*", "rram", "bitserial")]
    if order == "broad_first":
        rules.reverse()
    j, t = _both(rules, (J_IDEAL, T_IDEAL))
    for path in PATHS:
        assert _label(t.resolve(path)) == _label(j.resolve(path)), path
    want = ("pcm", "analog") if order == "specific_first" else \
        ("rram", "bitserial")
    assert _label(t.resolve("dec/layer_000/attn/wq")) == want
    assert _label(t.resolve("dec/layer_000/mlp/wg")) == ("ideal", "ideal")


def test_match_is_explicit_rules_only():
    j, t = _both([("*/moe/router", "sram_digital", "analog")],
                 (j_emt_preset("analog"), t_emt_preset("analog")))
    for path in PATHS:
        assert _label(t.match(path)) == _label(j.match(path)), path
    assert t.match("dec/layer_003/moe/router").corner == "sram_digital"
    plain = t_single(t_emt_preset("analog"))
    assert plain.match("dec/layer_000/moe/router") is None
    assert plain.resolve("dec/layer_000/moe/router").active


def test_as_placement_wraps_and_passes_through():
    emt = t_emt_preset("analog")
    p = t_as_placement(emt)
    assert isinstance(p, TPlacement) and p.default == emt and not p.rules
    assert t_as_placement(p) is p
    with pytest.raises(TypeError):
        t_as_placement({"mode": "analog"})
    jp = j_as_placement(j_emt_preset("analog"))
    assert (p.corners(), p.active, p.mode) == \
        (jp.corners(), jp.active, jp.mode)


def test_placement_corners_and_active_match_jax():
    assert T_PLACEMENTS == J_PLACEMENTS
    tp, jp = t_mixed(), j_mixed()
    assert set(tp.corners()) == {"pcm", "rram", "sram_digital"}
    assert tp.corners() == jp.corners()
    assert tp.active and tp.mode == "analog" == jp.mode
    assert not t_single(T_IDEAL).active and not j_single(J_IDEAL).active
    for path in PATHS:
        assert _fields(tp.resolve(path)) == _fields(jp.resolve(path)), path


@pytest.mark.parametrize("name", ["mixed", "attn-pcm", "digital-router"])
def test_placement_plan_matches_jax(name):
    """The resolved per-layer plan of gemma3-1b smoke, all-global, per-row
    DAC scale, as ServeSpec resolves it; every resolved config is equal."""
    jc = ServeSpec(arch="gemma3-1b", placement=name, all_global=True,
                   a_per_row=True, smoke=True).build_config()
    tc = build_config(smoke=True, placement=name, all_global=True,
                      a_per_row=True)
    assert tc.layer_paths() == jc.layer_paths()
    assert tc.placement_plan() == jc.placement_plan()
    for path in tc.layer_paths():
        assert _fields(tc.emt_at(path)) == _fields(jc.emt_at(path)), path
        assert _label(tc.emt_rule_at(path)) == _label(jc.emt_rule_at(path))


def test_plan_of_mixed_gemma3():
    """Attention on PCM (analog), MLPs bit-serial on RRAM, the tied unembed
    analog on PCM (the default)."""
    plan = dict((p, (c, m)) for p, c, m in
                build_config(smoke=True, placement="mixed").placement_plan())
    assert plan["dec/layer_000/attn/wq"] == ("pcm", "analog")
    assert plan["dec/layer_001/mlp/wd"] == ("rram", "bitserial")
    assert plan["unembed"] == ("pcm", "analog")
    assert {m for _, m in plan.values()} == {"analog", "bitserial"}


def test_get_config_rejects_knobs_beside_placement():
    for kw in (dict(emt_mode="analog"), dict(intensity="strong"),
               dict(device="pcm")):
        with pytest.raises(ValueError, match="placement= overrides"):
            j_get_config("gemma3-1b", smoke=True, placement="mixed", **kw)
        with pytest.raises(ValueError, match="placement= overrides"):
            t_get_config("gemma3-1b", smoke=True, placement="mixed", **kw)
    emt = t_emt_preset("analog")
    assert t_get_config("gemma3-1b", smoke=True, placement=emt).emt == emt
    with pytest.raises(KeyError, match="unknown placement preset"):
        t_get_config("gemma3-1b", smoke=True, placement="vaporware")


def test_build_config_placement_rules():
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_config(smoke=True, placement="mixed", device="pcm")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServeSpec(placement="mixed", device="pcm")
    with pytest.raises(ValueError, match="unknown placement"):
        build_config(smoke=True, placement="vaporware")
    with pytest.raises(ValueError, match="unknown device corner"):
        build_config(smoke=True, device="vaporware")
    cfg = build_config(smoke=True, placement="mixed", a_per_row=True)
    assert cfg.dtype == torch.float32
    # a_per_row reaches every corner of the placement, not only the default
    assert all(r.emt.quant.a_per_row for r in cfg.emt.rules)
    assert cfg.emt.default.quant.a_per_row
    off = build_config(smoke=True, placement="mixed")
    assert not any(r.emt.quant.a_per_row for r in off.emt.rules)
