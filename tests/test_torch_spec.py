"""Port parity of the declarative specs (``repro_torch.serve.spec``) with
``repro.serve.spec``, on the spec half of ``tests/test_scenario_matrix.py``:
JSON round trips, hard unknown-key rejection, the invalid combinations
(the same ``ValueError`` messages as JAX's), the ring-stack rejection,
unknown names, and ``ScenarioSpec`` / ``MatrixSpec`` expansion.  Dicts that
JAX's specs write (its ``default_matrix()`` too) load in the port and
expand to the same cells.  The accepted deviations (ROADMAP Queue 3):
``paged_attn_impl`` other than ``"auto"`` is refused at ``build_config``,
and ``build_engine`` initialises its own seeded weights on the torch
device it is given (the card by default, and no card raises).
"""
import json

import numpy as np
import pytest

from repro.serve import spec as jspec
from repro_torch.serve import spec as tspec
from repro_torch.serve.spec import (MatrixSpec, ScenarioSpec, ServeSpec,
                                    build_config)


def _both(fn):
    """fn(module) on JAX's spec module and the port's: (jax, torch)."""
    return fn(jspec), fn(tspec)


def _same_error(fn, exc=ValueError):
    """fn(module) raises `exc` with the same message on both sides."""
    msgs = []
    for mod in (jspec, tspec):
        with pytest.raises(exc) as err:
            fn(mod)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
    return msgs[1]


SERVE_KW = dict(arch="gemma3-1b", mode="analog", all_global=True,
                a_per_row=True, batch_size=2, max_len=32, paged=True,
                block_size=8, prefix_cache=True, frozen_noise=True,
                model_overrides={"num_layers": 2})


# ---------------------------------------------------------------- ServeSpec

def test_serve_spec_round_trip():
    spec = ServeSpec(**SERVE_KW)
    d = spec.to_dict()
    assert json.loads(json.dumps(d)) == d
    assert ServeSpec.from_dict(d) == spec
    assert spec.replace(batch_size=4).batch_size == 4
    assert spec.emt_label == "analog"
    assert spec.replace(device="pcm").emt_label == "pcm"
    jd, td = _both(lambda m: m.ServeSpec(**SERVE_KW).to_dict())
    assert td == jd
    assert ServeSpec.from_dict(jd) == spec
    assert ServeSpec().to_dict() == jspec.ServeSpec().to_dict()


def test_serve_spec_unknown_key_rejected():
    msg = _same_error(lambda m: m.ServeSpec.from_dict(
        {"arch": "gemma3-1b", "nope": 1}))
    assert "unknown ServeSpec keys" in msg


def test_serve_spec_impl_list_matches_reference():
    from repro.kernels.ops import PAGED_ATTN_IMPLS as KERNEL_IMPLS
    assert tspec.PAGED_ATTN_IMPLS == jspec.PAGED_ATTN_IMPLS \
        == tuple(KERNEL_IMPLS)
    assert tspec.MODES == jspec.MODES and tspec.ARRIVALS == jspec.ARRIVALS


@pytest.mark.parametrize("kw", [
    dict(mode="quantum"),
    dict(paged_attn_impl="cuda"),
    dict(placement="mixed", device="pcm"),
    dict(prefix_cache=True),                       # needs paged
    dict(batch_size=3, shards=2),
    dict(draft_placement="sram_digital", temperature=0.7),
    dict(draft_placement="sram_digital", shards=2, batch_size=4),
    dict(draft_placement="sram_digital", paged=True, prefix_cache=True),
    dict(top_p=0.0),
    dict(deadline_s=0.0),
    dict(energy_budget_uj=-1.0),
])
def test_serve_spec_invalid_combinations(kw):
    _same_error(lambda m: m.ServeSpec(**kw))


def test_prefix_cache_on_ring_stack_rejected():
    """gemma3-1b keeps its ring layers unless all_global: the prefix cache
    and speculation are refused at config resolution, as in JAX."""
    kw = dict(arch="gemma3-1b", smoke=True, paged=True, prefix_cache=True)
    msg = _same_error(lambda m: m.ServeSpec(**kw).build_config())
    assert "all-global" in msg
    _same_error(lambda m: m.ServeSpec(
        draft_placement="sram_digital").build_config())
    cfg = ServeSpec(**kw).replace(all_global=True).build_config()
    assert cfg.sliding_window == 0 and "local" not in cfg.blocks()


def test_build_config_rejects_unknown_names():
    assert "unknown arch" in _same_error(
        lambda m: m.ServeSpec(arch="gpt-17").build_config())
    assert "unknown placement" in _same_error(
        lambda m: m.ServeSpec(placement="everything-on-pcm").build_config())
    assert "unknown device" in _same_error(
        lambda m: m.ServeSpec(device="memristor-9000").build_config())


@pytest.mark.parametrize("arch", ["llama3-405b", "jamba-v0.1-52b",
                                  "qwen2-vl-72b"])
def test_unported_arch_is_not_yet_ported(arch):
    """An architecture JAX registers and the port has not ported yet is
    refused as such (Queue 1 item 9), not as an unknown name."""
    from repro.configs import ARCHS
    assert set(tspec.REFERENCE_ARCHS) == set(ARCHS)
    jspec.ServeSpec(arch=arch).validate()
    with pytest.raises(NotImplementedError, match="item 9"):
        ServeSpec(arch=arch).build_config()


@pytest.mark.parametrize("impl", ["pallas", "interpret", "ref"])
def test_paged_attn_impl_loads_but_only_auto_builds(impl):
    """JAX's kernel rungs load (its spec files keep the field) but the port
    picks its kernel by the tensors' device: only "auto" builds."""
    d = jspec.ServeSpec(paged_attn_impl=impl).to_dict()
    spec = ServeSpec.from_dict(d)
    assert spec.paged_attn_impl == impl
    with pytest.raises(ValueError, match="by the tensors' device"):
        spec.build_config()
    assert spec.replace(paged_attn_impl="auto").build_config() is not None


def test_build_config_function_is_the_spec():
    """The module-level build_config is ServeSpec.build_config."""
    for kw in (dict(all_global=True, a_per_row=True),
               dict(placement="mixed", all_global=True),
               dict(arch="seamless-m4t-medium", mode="ideal"),
               dict(all_global=True, prefix_cache=True,
                    model_overrides={"num_layers": 2})):
        spec = ServeSpec(paged=kw.get("prefix_cache", False), **kw)
        assert build_config(**kw) == spec.build_config()


def test_build_engine_on_the_cpu_and_not_yet_ported_modes():
    """build_engine builds the engine the spec describes on the torch
    device it is given, with its controller; without a card, the default
    ("cuda") raises instead of falling back; a draft placement builds the
    speculative engine; shards raise as not yet ported."""
    from repro_torch.serve.control import EnergyBudgetController
    spec = ServeSpec(**SERVE_KW).replace(step_budget_uj=1.0)
    eng = spec.build_engine(torch_device="cpu")
    assert eng.prefix_cache and eng.paged and eng.max_len == 32
    assert eng.kv.block_size == 8 and not eng.fresh_noise
    assert isinstance(eng.controller, EnergyBudgetController)
    assert eng.controller.step_budget_uj == 1.0
    assert spec.replace(step_budget_uj=None).build_controller() is None
    (res,) = eng.serve([eng_req(np.arange(5), max_new=2)])
    assert res.done_reason == "max_new" and len(res.tokens) == 2
    with pytest.raises(ValueError, match="max_len unresolved"):
        spec.replace(max_len=None).build_engine(torch_device="cpu")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            spec.build_engine()
    from repro_torch.serve.speculative import SpeculativeEngine
    spec_eng = ServeSpec(all_global=True, draft_placement="sram_digital",
                         spec_k=3, max_len=32).build_engine(
                             torch_device="cpu")
    assert isinstance(spec_eng, SpeculativeEngine) and spec_eng.spec_k == 3
    assert spec_eng.draft_cfg.emt.corner == "sram_digital"
    with pytest.raises(NotImplementedError, match="item 11"):
        ServeSpec(shards=2, max_len=32).build_engine(torch_device="cpu")


def eng_req(prompt, **kw):
    from repro_torch.serve.engine import GenRequest
    return GenRequest(prompt=np.asarray(prompt, np.int32), **kw)


# ------------------------------------------------------------- ScenarioSpec

def test_scenario_spec_round_trip_and_coords():
    def make(m):
        return m.ScenarioSpec(
            name="c", serve=m.ServeSpec(batch_size=2), arrival="stagger",
            stagger=2, n_requests=4, prompt_lo=16, prompt_hi=16,
            shared_prefix_ratio=0.5, max_new=4,
            coords=(("kv", "paged"), ("shared", "0.5")))

    jc, cell = _both(make)
    d = cell.to_dict()
    assert json.loads(json.dumps(d)) == d
    assert ScenarioSpec.from_dict(d) == cell
    assert d == jc.to_dict()
    assert ScenarioSpec.from_dict(jc.to_dict()) == cell
    assert cell.header_len == 8
    assert cell.coord("kv") == "paged"
    assert cell.group_key(drop_axes=("kv",)) == (("shared", "0.5"),)
    assert "unknown ScenarioSpec keys" in _same_error(
        lambda m: m.ScenarioSpec.from_dict({"n_requests": 4,
                                            "arrivals": "poisson"}))


@pytest.mark.parametrize("kw", [
    dict(arrival="burst"),
    dict(arrival="poisson", rate_rps=0.0),
    dict(arrival="stagger", stagger=0),
    dict(prompt_lo=8, prompt_hi=4),
    dict(shared_prefix_ratio=1.0),
    dict(n_requests=0),
])
def test_scenario_spec_invalid(kw):
    _same_error(lambda m: m.ScenarioSpec(**kw))


# --------------------------------------------------------------- MatrixSpec

def _toggle(label, **set_):
    return {"label": label,
            "set": {k.replace("__", "."): v for k, v in set_.items()}}


def _matrix(m):
    base = m.ScenarioSpec(name="grid", serve=m.ServeSpec())
    extra = m.ScenarioSpec(name="poisson", arrival="poisson", rate_rps=4.0)
    return m.MatrixSpec(
        name="m", base=base,
        axes={"shared_prefix_ratio": (0.0, 0.5),
              "kv": (_toggle("contig", serve__paged=False),
                     _toggle("paged", serve__paged=True),
                     _toggle("prefix", serve__paged=True,
                             serve__prefix_cache=True))},
        identity_axes=("kv",), extra_cells=(extra,))


def test_matrix_expansion_counts_and_names():
    jm, m = _both(_matrix)
    assert m.n_cells == 2 * 3 + 1
    cells = m.expand()
    assert len(cells) == 7
    assert len({c.name for c in cells}) == 7
    assert [c.to_dict() for c in cells] == \
        [c.to_dict() for c in jm.expand()]
    grid = [c for c in cells if c.coords]
    assert all(c.name.startswith("grid/") for c in grid)
    pc = next(c for c in grid if c.coord("kv") == "prefix"
              and c.coord("shared_prefix_ratio") == "0.5")
    assert pc.shared_prefix_ratio == 0.5 and pc.serve.prefix_cache
    groups = {}
    for c in grid:
        groups.setdefault(c.group_key(m.identity_axes), []).append(c)
    assert len(groups) == 2 and all(len(v) == 3 for v in groups.values())


def test_matrix_round_trip_and_validation():
    m = MatrixSpec(name="m", base=ScenarioSpec(),
                   axes={"max_new": (4, 8)}, identity_axes=())
    assert MatrixSpec.from_dict(json.loads(json.dumps(m.to_dict()))) == m
    jm = jspec.MatrixSpec(name="m", base=jspec.ScenarioSpec(),
                          axes={"max_new": (4, 8)})
    assert m.to_dict() == jm.to_dict()
    assert "identity axis" in _same_error(lambda mod: mod.MatrixSpec(
        axes={"max_new": (4,)}, identity_axes=("kv",)))
    assert "unknown field" in _same_error(lambda mod: mod.MatrixSpec(
        axes={"max_old": (4, 8)}).expand())
    assert "arrival" in _same_error(lambda mod: mod.MatrixSpec(
        axes={"arrival": ("lockstep", "burst")}).expand())


@pytest.mark.parametrize("smoke", [True, False])
def test_default_matrix_cells_load(smoke):
    """JAX's default scenario matrix, as its to_dict() writes it, loads in
    the port and expands to the same cells; every cell's config resolves
    once its kernel rung is the port's "auto"."""
    from benchmarks.matrix import default_matrix
    jm = default_matrix(smoke=smoke)
    d = json.loads(json.dumps(jm.to_dict()))
    m = MatrixSpec.from_dict(d)
    assert m.to_dict() == jm.to_dict()
    cells = m.expand()
    assert [c.to_dict() for c in cells] == \
        [c.to_dict() for c in jm.expand()]
    assert len(cells) == m.n_cells == (5 if smoke else 13)
    for c in cells:
        assert c.serve.paged_attn_impl == "ref"
        cfg = c.serve.replace(paged_attn_impl="auto").build_config()
        assert "local" not in cfg.blocks()


@pytest.mark.parametrize("smoke", [True, False])
def test_make_requests_matches_jax(smoke):
    """The port's make_requests draws the JAX matrix's requests for every
    default cell: the same prompts, budgets, seeds and sampling defaults."""
    from benchmarks.matrix import default_matrix, make_requests
    for jc in default_matrix(smoke=smoke).expand():
        cell = ScenarioSpec.from_dict(json.loads(json.dumps(jc.to_dict())))
        want = make_requests(jc, 1000)
        got = tspec.make_requests(cell, 1000)
        assert len(got) == len(want) == cell.n_requests
        for a, b in zip(got, want):
            assert a.prompt.dtype == np.int32
            np.testing.assert_array_equal(a.prompt, np.asarray(b.prompt))
            for f in ("max_new", "seed", "temperature", "top_k", "top_p",
                      "eos_id", "energy_budget_uj"):
                assert getattr(a, f) == getattr(b, f), f
