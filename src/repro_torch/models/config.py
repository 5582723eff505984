"""Model configuration (port of :mod:`repro.models.config`), reduced to the
fields the port's decoder stacks (attention, mixture of experts, mamba and
xLSTM blocks) and encoder-decoder stacks read, with per-layer device
placement."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.core.emt_linear import EMTConfig, IDEAL
from repro_torch.core.placement import DevicePlacement, as_placement

ATTN_KINDS = ("attn", "global", "local")
# recurrent sequence mixers (models/mamba.py, models/xlstm.py)
RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    rope_type: str = "default"       # default | mrope
    # M-RoPE (qwen2-vl): lanes of each (t, h, w) stream, of head_dim / 2
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0
    layer_pattern: Tuple[str, ...] = ("attn",)
    qk_norm: bool = False
    attn_chunk: int = 4096           # KV chunk of the online-softmax path
    # paged attention through the fused kernels (False: scatter + gather +
    # _gqa_core, the plain path)
    fused_paged_attn: bool = True
    # mixture of experts (models/moe.py)
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1               # MoE every k-th layer (others dense MLP)
    router_aux_weight: float = 0.01
    # ssm (mamba)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0: ceil(d_model / 16)
    # xlstm: True runs sLSTM's exact R-matrix recurrence token by token
    slstm_recurrent: bool = False
    encoder_layers: int = 0          # > 0: encoder-decoder (seamless)
    # tokens | embeds (the vision and early-fusion front ends' stubs:
    # precomputed (B, S, d_model) input embeddings)
    input_kind: str = "tokens"
    tie_embeddings: bool = False
    embed_scale: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: Any = torch.bfloat16
    emt: Union[EMTConfig, DevicePlacement] = IDEAL
    logit_dtype: Any = torch.float32

    def __post_init__(self):
        if self.rope_type not in ("default", "mrope"):
            raise ValueError(f"unknown rope_type {self.rope_type!r}")
        if self.input_kind not in ("tokens", "embeds"):
            raise ValueError(f"unknown input_kind {self.input_kind!r}")
        bad = sorted(set(self.layer_pattern) - set(ATTN_KINDS)
                     - set(RECURRENT_KINDS))
        if bad:
            raise ValueError(f"unknown block kinds {bad}")

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def blocks(self) -> Tuple[str, ...]:
        """Resolve layer_pattern into a per-layer block-kind tuple."""
        pat = self.layer_pattern
        reps = -(-self.num_layers // len(pat))
        return tuple((pat * reps)[: self.num_layers])

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        """Which layers carry the MoE FFN (True) and which the dense one."""
        if self.num_experts == 0:
            return tuple(False for _ in range(self.num_layers))
        return tuple((i % self.moe_every) == (self.moe_every - 1)
                     for i in range(self.num_layers))

    # --- heterogeneous device placement -----------------------------------
    @property
    def placement(self) -> DevicePlacement:
        return as_placement(self.emt)

    def emt_at(self, path: str) -> EMTConfig:
        """Resolved EMT config of the layer at canonical `path`."""
        return self.placement.resolve(path)

    def emt_rule_at(self, path: str) -> Optional[EMTConfig]:
        """Explicit-rule-only resolution (None unless a rule matches)."""
        return self.placement.match(path)

    def layer_paths(self) -> Tuple[str, ...]:
        """All canonical placement paths of this model, in build order: the
        encoder stack (enc-dec only), then the decoder stack (per layer the
        attention projections or the mamba ones (``in``, ``xp``, ``dt``,
        ``out``), cross attention in an enc-dec stack, the GLU MLP or, on a
        MoE layer, the expert stack then the router; an mLSTM or sLSTM
        block holds its own projections and no FFN), then the unembed."""
        paths = []
        own = {"mlstm": ("up", "wq", "wk", "wv", "wi", "wf", "down"),
               "slstm": ("wz", "wi", "wf", "wo", "up", "down")}

        def stack_paths(prefix, kinds, moe_mask, cross):
            for i, kind in enumerate(kinds):
                base = f"{prefix}/layer_{i:03d}"
                if kind in own:
                    paths.extend(f"{base}/{kind}/{w}" for w in own[kind])
                    continue                    # self-contained, no FFN
                if kind == "mamba":
                    paths.extend(f"{base}/mamba/{w}"
                                 for w in ("in", "xp", "dt", "out"))
                else:
                    paths.extend(f"{base}/attn/{w}"
                                 for w in ("wq", "wk", "wv", "wo"))
                if cross:
                    paths.extend(f"{base}/xattn/{w}"
                                 for w in ("wq", "wk", "wv", "wo"))
                if moe_mask[i]:
                    paths.append(f"{base}/moe/experts")
                    paths.append(f"{base}/moe/router")
                elif self.d_ff > 0:
                    paths.extend(f"{base}/mlp/{w}" for w in ("wg", "wu", "wd"))

        if self.is_encdec:
            stack_paths("enc", ("attn",) * self.encoder_layers,
                        (False,) * self.encoder_layers, False)
        stack_paths("dec", self.blocks(), self.moe_layer_mask(),
                    self.is_encdec)
        paths.append("unembed")
        return tuple(paths)

    def placement_plan(self) -> Tuple[Tuple[str, str, str], ...]:
        """Resolved (path, corner, mode) triples: the static per-layer
        plan.  A router reports what the MoE layer does with it: digital
        fp32 unless an explicit rule places it (the default never
        applies)."""
        plan = []
        for p in self.layer_paths():
            if p.endswith("/moe/router"):
                hit = self.emt_rule_at(p)
                plan.append((p, "digital", "fp32") if hit is None
                            else (p, hit.corner_label, hit.mode))
                continue
            emt = self.emt_at(p)
            plan.append((p, emt.corner_label, emt.mode))
        return tuple(plan)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
