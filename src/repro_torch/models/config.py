"""Model configuration (port of :mod:`repro.models.config`), reduced to the
fields the port's dense decoder and encoder-decoder stacks read, with
per-layer device placement."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.core.emt_linear import EMTConfig, IDEAL
from repro_torch.core.placement import DevicePlacement, as_placement

ATTN_KINDS = ("attn", "global", "local")


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
    rope_type: str = "default"
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0
    layer_pattern: Tuple[str, ...] = ("attn",)
    qk_norm: bool = False
    attn_chunk: int = 4096           # KV chunk of the online-softmax path
    # paged attention through the fused kernels (False: scatter + gather +
    # _gqa_core, the plain path)
    fused_paged_attn: bool = True
    encoder_layers: int = 0          # > 0: encoder-decoder (seamless)
    tie_embeddings: bool = False
    embed_scale: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: Any = torch.bfloat16
    emt: Union[EMTConfig, DevicePlacement] = IDEAL
    logit_dtype: Any = torch.float32

    def __post_init__(self):
        if self.rope_type != "default":
            raise NotImplementedError(
                f"rope_type {self.rope_type!r} (M-RoPE) is ported with a "
                f"later slice (ROADMAP Queue 1, remaining architectures)")
        bad = sorted(set(self.layer_pattern) - set(ATTN_KINDS))
        if bad:
            raise NotImplementedError(
                f"block kinds {bad} are ported with a later slice (ROADMAP "
                f"Queue 1, remaining architectures)")

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def blocks(self) -> Tuple[str, ...]:
        """Resolve layer_pattern into a per-layer block-kind tuple."""
        pat = self.layer_pattern
        reps = -(-self.num_layers // len(pat))
        return tuple((pat * reps)[: self.num_layers])

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
        encoder stack (enc-dec only), then the decoder stack (attention
        projections, cross attention in an enc-dec stack, the GLU MLP),
        then the unembed."""
        paths = []

        def stack_paths(prefix, layers, cross):
            for i in range(layers):
                base = f"{prefix}/layer_{i:03d}"
                paths.extend(f"{base}/attn/{w}"
                             for w in ("wq", "wk", "wv", "wo"))
                if cross:
                    paths.extend(f"{base}/xattn/{w}"
                                 for w in ("wq", "wk", "wv", "wo"))
                if self.d_ff > 0:
                    paths.extend(f"{base}/mlp/{w}" for w in ("wg", "wu", "wd"))

        if self.is_encdec:
            stack_paths("enc", self.encoder_layers, False)
        stack_paths("dec", self.num_layers, self.is_encdec)
        paths.append("unembed")
        return tuple(paths)

    def placement_plan(self) -> Tuple[Tuple[str, str, str], ...]:
        """Resolved (path, corner, mode) triples: the static per-layer
        plan."""
        plan = []
        for p in self.layer_paths():
            emt = self.emt_at(p)
            plan.append((p, emt.corner_label, emt.mode))
        return tuple(plan)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
