"""llama4-scout-17b-a16e [moe]: 16-expert top-1 MoE with early fusion (stub).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.common import emt_preset, shrink
from repro_torch.models.config import ModelConfig


def build(emt=None) -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        num_experts=16,
        experts_per_token=1,
        moe_d_ff=8192,
        moe_every=1,
        rope_theta=5.0e5,
        input_kind="embeds",            # early-fusion multimodal stub
        emt=emt or emt_preset(),
    )


def smoke(emt=None) -> ModelConfig:
    return shrink(build(emt))
