"""moonshot-v1-16b-a3b [moe]: Moonlight-style fine-grained MoE, 64 experts,
top-6.

48L d_model=2048 16H (MHA kv=16) d_ff=1408 vocab=163840
[hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.common import emt_preset, shrink
from repro_torch.models.config import ModelConfig


def build(emt=None) -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163840,
        num_experts=64,
        experts_per_token=6,
        moe_d_ff=1408,
        moe_every=1,
        rope_theta=5.0e4,
        emt=emt or emt_preset(),
    )


def smoke(emt=None) -> ModelConfig:
    return shrink(build(emt))
