"""Declarative serving and benchmark specs (port of :mod:`repro.serve.spec`):
one config surface for everything that serves through the port.

* :class:`ServeSpec`: how to serve (arch and EMT placement, engine shape,
  KV layout, chunked prefill and the prefix cache, speculation, the
  control plane's budgets, sharding, the streaming front end's bounds,
  default sampling), validated in one place: every combination the engines
  would refuse deep inside construction is a ``ValueError`` at spec time.
  ``build_config()`` resolves the :class:`~repro_torch.models.config.
  ModelConfig`; ``build_engine()`` constructs the engine.
* :class:`ScenarioSpec`: what to serve, a workload cell around a
  ``ServeSpec`` (arrival process, request count, prompt-length mix,
  shared-prefix ratio, decode budget) and the matrix coordinates stamped
  on it; :func:`make_requests` draws its deterministic requests.
* :class:`MatrixSpec`: a scenario matrix (a base cell, axes of dotted field
  paths or labelled compound toggles, identity axes, extra cells);
  ``expand()`` yields the cartesian product as validated cells.

Each is JSON round-trippable (``to_dict`` / ``from_dict``, unknown keys
rejected), and a dict the JAX package's specs write loads here.  The port
picks its kernels by the tensors' device, so ``paged_attn_impl`` keeps the
JAX package's field and values but ``build_config`` accepts only
``"auto"``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import PLACEMENTS, get_config
from repro_torch.core.device import get_device
from repro_torch.core.placement import map_corners
from repro_torch.serve.engine import GenRequest, _later

MODES = ("ideal", "analog", "bitserial")
ARRIVALS = ("lockstep", "stagger", "poisson")

# the JAX package's kernel dispatch rungs: accepted in a spec so that its
# spec files load; the port's build_config takes only "auto"
PAGED_ATTN_IMPLS = ("auto", "pallas", "interpret", "ref")

# every architecture the JAX package registers (the port's configs.ARCHS)
REFERENCE_ARCHS = ("jamba-v0.1-52b", "qwen2-vl-72b", "moonshot-v1-16b-a3b",
                   "llama4-scout-17b-a16e", "xlstm-350m", "deepseek-67b",
                   "gemma3-1b", "llama3-405b", "gemma2-9b",
                   "seamless-m4t-medium")


def _reject_unknown(cls, d: dict):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys {unknown}; "
                         f"known: {sorted(known)}")


def _err(cond: bool, msg: str):
    if cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """How to serve: engine, placement, kernel, speculation knobs and their
    validation.  The launcher and ``chip_smoke.py`` build their config
    and engine through it."""
    # -- model / placement ---------------------------------------------------
    arch: str = "gemma3-1b"
    mode: str = "analog"                 # ideal | analog | bitserial
    device: Optional[str] = None         # one registered EMT corner
    placement: Optional[str] = None      # per-layer preset (PLACEMENTS)
    smoke: bool = True
    all_global: bool = False             # coerce ring layers to global
    a_per_row: bool = False              # per-row DAC activation scale
    model_overrides: Optional[Dict[str, Any]] = None   # cfg.replace(**kw)
    # -- engine --------------------------------------------------------------
    batch_size: int = 4
    max_len: Optional[int] = None        # None: callers derive it
    seed: int = 0
    frozen_noise: bool = False           # freeze EMT fluctuation at the seed
    # -- KV memory -----------------------------------------------------------
    paged: bool = False
    block_size: int = 16
    num_blocks: Optional[int] = None
    num_ring_blocks: Optional[int] = None
    # -- kernels -------------------------------------------------------------
    fused_paged_attn: bool = True
    paged_attn_impl: str = "auto"
    # -- prefill / prefix cache ----------------------------------------------
    chunked_prefill: Optional[bool] = None
    prefill_chunk: int = 16
    prefix_cache: bool = False
    # -- speculation ---------------------------------------------------------
    draft_placement: Optional[str] = None
    spec_k: int = 4
    # -- control plane -------------------------------------------------------
    energy_budget_uj: Optional[float] = None   # per-request SLA
    step_budget_uj: Optional[float] = None     # rolling admission bucket
    # -- sharding ------------------------------------------------------------
    shards: int = 1
    # -- streaming front end -------------------------------------------------
    max_pending: int = 16
    deadline_s: Optional[float] = None
    # -- default sampling (per request) --------------------------------------
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None

    def __post_init__(self):
        _err(self.mode not in MODES,
             f"mode {self.mode!r} not in {MODES}")
        _err(self.paged_attn_impl not in PAGED_ATTN_IMPLS,
             f"paged_attn_impl {self.paged_attn_impl!r} not in "
             f"{PAGED_ATTN_IMPLS}")
        _err(self.placement is not None and self.device is not None,
             "placement and device are mutually exclusive (a placement "
             "names its corners per layer)")
        _err(self.batch_size < 1, f"batch_size {self.batch_size} < 1")
        _err(self.max_len is not None and self.max_len < 2,
             f"max_len {self.max_len} < 2")
        _err(self.block_size < 1, f"block_size {self.block_size} < 1")
        _err(self.prefill_chunk < 1, f"prefill_chunk {self.prefill_chunk} < 1")
        _err(self.spec_k < 1, f"spec_k {self.spec_k} < 1")
        _err(self.shards < 1, f"shards {self.shards} < 1")
        _err(self.batch_size % self.shards != 0,
             f"batch_size {self.batch_size} not divisible by shards "
             f"{self.shards}")
        _err(self.prefix_cache and not self.paged,
             "prefix_cache requires paged=True (refcounted block sharing "
             "needs the block-table pool)")
        _err(self.draft_placement is not None and self.shards > 1,
             "speculative decoding is single-device for now (the draft "
             "shadow cache and verify step are not sharded)")
        _err(self.draft_placement is not None and self.temperature > 0,
             "speculative decoding is greedy-only (temperature must be 0)")
        _err(self.prefix_cache and self.draft_placement is not None,
             "speculation does not compose with the prefix cache yet "
             "(ROADMAP item 3)")
        _err(self.max_pending < 1, f"max_pending {self.max_pending} < 1")
        _err(self.deadline_s is not None and self.deadline_s <= 0,
             f"deadline_s {self.deadline_s} must be positive")
        for name in ("energy_budget_uj", "step_budget_uj"):
            v = getattr(self, name)
            _err(v is not None and v <= 0, f"{name} {v} must be positive")
        _err(self.temperature < 0, f"temperature {self.temperature} < 0")
        _err(self.top_k < 0, f"top_k {self.top_k} < 0")
        _err(not (0.0 < self.top_p <= 1.0),
             f"top_p {self.top_p} not in (0, 1]")
        if self.model_overrides is not None:
            _err(not isinstance(self.model_overrides, dict)
                 or not all(isinstance(k, str) for k in self.model_overrides),
                 "model_overrides must be a {field: value} dict")

    # -- round trip ----------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeSpec":
        _reject_unknown(cls, d)
        return cls(**d)

    def replace(self, **kw) -> "ServeSpec":
        return dataclasses.replace(self, **kw)

    # -- resolution ----------------------------------------------------------
    @property
    def emt_label(self) -> str:
        """Grouping label for reports: the placement preset, the pinned
        corner, or the single-corner mode."""
        return self.placement or self.device or self.mode

    def validate(self) -> "ServeSpec":
        """Deep validation: resolve the model config, so stack-dependent
        combinations and unknown names are refused too.  Returns self."""
        self.build_config()
        return self

    def build_config(self):
        """Resolve the :class:`ModelConfig` this spec serves (float32)."""
        _err(self.arch not in REFERENCE_ARCHS,
             f"unknown arch {self.arch!r}; known: {sorted(REFERENCE_ARCHS)}")
        _err(self.paged_attn_impl != "auto",
             f"paged_attn_impl {self.paged_attn_impl!r}: the port picks its "
             f"kernel by the tensors' device (a CUDA tensor launches the "
             f"kernel, a CPU tensor takes its plain version); only 'auto' "
             f"is accepted")
        if self.placement is not None:
            _err(self.placement not in PLACEMENTS,
                 f"unknown placement {self.placement!r}; known: "
                 f"{sorted(PLACEMENTS)}")
            cfg = get_config(self.arch, smoke=self.smoke,
                             placement=self.placement)
        else:
            if self.device is not None:
                try:
                    get_device(self.device)
                except KeyError as e:
                    raise ValueError(f"unknown device corner "
                                     f"{self.device!r}") from e
            cfg = get_config(self.arch, emt_mode=self.mode, smoke=self.smoke,
                             device=self.device)
        cfg = cfg.replace(dtype=torch.float32,
                          fused_paged_attn=self.fused_paged_attn)
        has_ring = bool(cfg.sliding_window) and "local" in cfg.blocks()
        if self.all_global and has_ring:
            cfg = cfg.replace(layer_pattern=("attn",), sliding_window=0)
            has_ring = False
        _err(self.prefix_cache and has_ring,
             "prefix_cache requires an all-global attention stack (ring K/V "
             "is positional and cannot be shared) — set all_global=True or "
             "pick a stack without sliding windows")
        _err(self.draft_placement is not None and has_ring,
             "speculative decoding requires an all-global attention stack "
             "(rejected-draft writes would clobber ring K/V) — set "
             "all_global=True")
        if self.model_overrides:
            cfg = cfg.replace(**self.model_overrides)
        if self.a_per_row:
            cfg = cfg.replace(emt=_quant_per_row(cfg.emt))
        return cfg

    def engine_kwargs(self, *, max_len: Optional[int] = None) -> dict:
        """Constructor kwargs of :class:`ServingEngine` (without cfg and
        params)."""
        max_len = self.max_len if max_len is None else max_len
        _err(max_len is None,
             "max_len unresolved: set ServeSpec.max_len or pass max_len= "
             "(scenario executors derive it from the workload)")
        return dict(
            batch_size=self.batch_size, max_len=max_len, seed=self.seed,
            fresh_noise=not self.frozen_noise, paged=self.paged,
            block_size=self.block_size, num_blocks=self.num_blocks,
            num_ring_blocks=self.num_ring_blocks,
            chunked_prefill=self.chunked_prefill,
            prefill_chunk=self.prefill_chunk, prefix_cache=self.prefix_cache,
            n_shards=self.shards)

    def request_kwargs(self) -> dict:
        """Per-request :class:`GenRequest` defaults this spec carries."""
        return dict(temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p, eos_id=self.eos_id,
                    energy_budget_uj=self.energy_budget_uj)

    def build_controller(self):
        """The energy control plane, if a budget is set (else None)."""
        if self.step_budget_uj is None and self.energy_budget_uj is None:
            return None
        from repro_torch.serve.control import EnergyBudgetController
        return EnergyBudgetController(step_budget_uj=self.step_budget_uj)

    def build_engine(self, cfg=None, params=None, *,
                     max_len: Optional[int] = None, on_token=None,
                     torch_device="cuda"):
        """Construct the engine this spec describes on `torch_device` (the
        card unless the caller asks for the CPU; ``device`` is the EMT
        corner).  `cfg` defaults to ``build_config()`` and `params` to the
        port's seeded init (seed 0) on that device; pass them to share
        weights across engines.  With ``draft_placement`` set it is a
        :class:`~repro_torch.serve.speculative.SpeculativeEngine`."""
        from repro_torch import resolve_device
        from repro_torch.models import lm
        from repro_torch.serve.engine import ServingEngine

        if self.shards > 1:
            raise _later("sharded serving (shards > 1)",
                         "item 11, multi-device serving")
        dev = resolve_device(torch_device)
        if cfg is None:
            cfg = self.build_config()
        if params is None:
            params = lm.init_model_params(cfg, 0, device=dev)
        kw = self.engine_kwargs(max_len=max_len)
        kw.update(on_token=on_token, controller=self.build_controller(),
                  device=dev)
        if self.draft_placement is not None:
            from repro_torch.serve.speculative import SpeculativeEngine
            return SpeculativeEngine(cfg, params,
                                     draft_placement=self.draft_placement,
                                     spec_k=self.spec_k, **kw)
        return ServingEngine(cfg, params, **kw)


def build_config(arch: str = "gemma3-1b", mode: str = "analog", *,
                 smoke: bool = True, device: Optional[str] = None,
                 placement: Optional[str] = None, all_global: bool = False,
                 a_per_row: bool = False, prefix_cache: bool = False,
                 model_overrides=None):
    """``ServeSpec(...).build_config()`` for the config knobs alone (a
    prefix cache implies the paged layout it needs)."""
    return ServeSpec(arch=arch, mode=mode, smoke=smoke, device=device,
                     placement=placement, all_global=all_global,
                     a_per_row=a_per_row, paged=prefix_cache,
                     prefix_cache=prefix_cache,
                     model_overrides=model_overrides).build_config()


def _quant_per_row(emt):
    """Switch every corner of an EMT surface to per-row DAC scales."""
    return map_corners(emt, lambda e: e.replace(
        quant=dataclasses.replace(e.quant, a_per_row=True)))


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """What to serve: one workload cell around a :class:`ServeSpec`.

    ``coords`` carries the matrix coordinates the expansion stamped on the
    cell (``(("kv", "paged_fused"), ("shared", "0.5"))``), which reducers
    group by without parsing names."""
    name: str = "cell"
    serve: ServeSpec = dataclasses.field(default_factory=ServeSpec)
    # -- arrival process -----------------------------------------------------
    arrival: str = "lockstep"        # lockstep | stagger | poisson
    stagger: int = 0                 # steps between submissions (stagger)
    rate_rps: float = 0.0            # open-loop Poisson rate (poisson)
    # -- request mix ---------------------------------------------------------
    n_requests: int = 8
    prompt_lo: int = 8               # uniform prompt-length mix [lo, hi]
    prompt_hi: int = 8
    shared_prefix_ratio: float = 0.0   # leading fraction of prompt_lo shared
    #                                    by every request (a system prompt)
    max_new: int = 8
    workload_seed: int = 0
    coords: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        _err(self.arrival not in ARRIVALS,
             f"arrival {self.arrival!r} not in {ARRIVALS}")
        _err(self.arrival == "poisson" and self.rate_rps <= 0,
             "poisson arrival needs rate_rps > 0")
        _err(self.arrival == "stagger" and self.stagger < 1,
             "stagger arrival needs stagger >= 1")
        _err(self.n_requests < 1, f"n_requests {self.n_requests} < 1")
        _err(not (1 <= self.prompt_lo <= self.prompt_hi),
             f"prompt mix [{self.prompt_lo}, {self.prompt_hi}] invalid")
        _err(not (0.0 <= self.shared_prefix_ratio < 1.0),
             f"shared_prefix_ratio {self.shared_prefix_ratio} not in [0, 1)")
        _err(self.max_new < 1, f"max_new {self.max_new} < 1")
        object.__setattr__(self, "coords",
                           tuple((str(a), str(v)) for a, v in self.coords))

    @property
    def header_len(self) -> int:
        """Tokens of the shared header every request starts with."""
        return int(round(self.shared_prefix_ratio * self.prompt_lo))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["serve"] = self.serve.to_dict()
        d["coords"] = [list(c) for c in self.coords]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        _reject_unknown(cls, d)
        d = dict(d)
        if "serve" in d and isinstance(d["serve"], dict):
            d["serve"] = ServeSpec.from_dict(d["serve"])
        if "coords" in d:
            d["coords"] = tuple(tuple(c) for c in d["coords"])
        return cls(**d)

    def replace(self, **kw) -> "ScenarioSpec":
        return dataclasses.replace(self, **kw)

    def coord(self, axis: str, default: str = "") -> str:
        return dict(self.coords).get(axis, default)

    def group_key(self, drop_axes=()) -> Tuple[Tuple[str, str], ...]:
        """Coordinates minus `drop_axes`: the identity-group key."""
        return tuple((a, v) for a, v in self.coords if a not in drop_axes)


def make_requests(cell: ScenarioSpec, vocab: int):
    """Deterministic request list for a cell (port of the JAX package's
    ``benchmarks/matrix.py`` ``make_requests``): an optional shared header
    (``shared_prefix_ratio`` of ``prompt_lo``) + unique tails, lengths
    uniform in [prompt_lo, prompt_hi].  Depends only on the workload fields
    (never on serve/engine knobs), so cells in one identity group serve the
    exact same requests."""
    rng = np.random.default_rng(cell.workload_seed + 1_000)
    header = rng.integers(0, vocab, cell.header_len).astype(np.int32)
    kw = cell.serve.request_kwargs()
    reqs = []
    for i in range(cell.n_requests):
        n = int(rng.integers(cell.prompt_lo, cell.prompt_hi + 1))
        tail = rng.integers(0, vocab,
                            max(1, n - cell.header_len)).astype(np.int32)
        reqs.append(GenRequest(prompt=np.concatenate([header, tail]),
                               max_new=cell.max_new, seed=i, **kw))
    return reqs


def _axis_label(value) -> str:
    if isinstance(value, dict):
        return str(value["label"])
    if value is None:
        return "none"
    if isinstance(value, bool):
        return "on" if value else "off"
    return str(value)


def _apply_field(d: dict, dotted: str, value):
    """Set a dotted field path ('serve.paged') inside a nested spec dict."""
    parts = dotted.split(".")
    for p in parts[:-1]:
        node = d.get(p)
        if not isinstance(node, dict):
            raise ValueError(f"axis path {dotted!r}: {p!r} is not a nested "
                             f"spec field")
        d = node
    if parts[-1] not in d:
        raise ValueError(f"axis path {dotted!r}: unknown field {parts[-1]!r}")
    d[parts[-1]] = value


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    """A declarative scenario matrix.

    ``axes`` maps an axis name to its values, each either a plain value (the
    axis name is then a dotted field path into :class:`ScenarioSpec`,
    ``"serve.paged": [false, true]``) or a compound toggle (``{"label":
    "paged_fused", "set": {"serve.paged": true, ...}}``) that flips several
    fields at once.  ``identity_axes`` names axes whose cells must stay
    token-identical (the same workload through another memory or kernel
    path).  ``expand()`` returns the cartesian product plus
    ``extra_cells`` as validated :class:`ScenarioSpec` cells."""
    name: str = "matrix"
    base: ScenarioSpec = dataclasses.field(default_factory=ScenarioSpec)
    axes: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    identity_axes: Tuple[str, ...] = ()
    extra_cells: Tuple[ScenarioSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "axes", {k: tuple(v) for k, v in self.axes.items()})
        object.__setattr__(self, "identity_axes", tuple(self.identity_axes))
        object.__setattr__(self, "extra_cells", tuple(self.extra_cells))
        for ax in self.identity_axes:
            _err(ax not in self.axes,
                 f"identity axis {ax!r} is not an axis; "
                 f"axes: {sorted(self.axes)}")
        for ax, values in self.axes.items():
            _err(len(values) == 0, f"axis {ax!r} has no values")

    @property
    def n_cells(self) -> int:
        n = 1
        for values in self.axes.values():
            n *= len(values)
        return (n if self.axes else 0) + len(self.extra_cells)

    def expand(self):
        """Cartesian product of the axes over `base`, then the extra
        cells."""
        cells = []
        names = list(self.axes)
        for combo in itertools.product(*(self.axes[a] for a in names)):
            d = self.base.to_dict()
            coords = []
            for axis, value in zip(names, combo):
                coords.append((axis, _axis_label(value)))
                if isinstance(value, dict):
                    for dotted, v in value["set"].items():
                        _apply_field(d, dotted, v)
                else:
                    _apply_field(d, axis, value)
            d["coords"] = coords
            d["name"] = "/".join([self.base.name]
                                 + [f"{a}={v}" for a, v in coords])
            cells.append(ScenarioSpec.from_dict(d))
        cells.extend(self.extra_cells)
        seen = set()
        for c in cells:
            _err(c.name in seen, f"duplicate cell name {c.name!r}")
            seen.add(c.name)
        return cells

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "base": self.base.to_dict(),
            "axes": {k: list(v) for k, v in self.axes.items()},
            "identity_axes": list(self.identity_axes),
            "extra_cells": [c.to_dict() for c in self.extra_cells],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MatrixSpec":
        _reject_unknown(cls, d)
        d = dict(d)
        if "base" in d and isinstance(d["base"], dict):
            d["base"] = ScenarioSpec.from_dict(d["base"])
        if "extra_cells" in d:
            d["extra_cells"] = tuple(
                ScenarioSpec.from_dict(c) if isinstance(c, dict) else c
                for c in d["extra_cells"])
        return cls(**d)
