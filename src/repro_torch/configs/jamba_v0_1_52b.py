"""jamba-v0.1-52b [hybrid]: Mamba + attention 1:7 interleave, MoE 16
experts top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536  [arXiv:2403.19887]
MoE on every other layer (AI21 Jamba), the experts of the FFN's width.
"""
from repro_torch.configs.common import emt_preset, shrink
from repro_torch.models.config import ModelConfig


def build(emt=None) -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        layer_pattern=("mamba", "mamba", "mamba", "attn",
                       "mamba", "mamba", "mamba", "mamba"),   # 1:7 attn:mamba
        num_experts=16,
        experts_per_token=2,
        moe_d_ff=14336,
        moe_every=2,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        rope_theta=1.0e6,
        emt=emt or emt_preset(),
    )


def smoke(emt=None) -> ModelConfig:
    return shrink(build(emt))
