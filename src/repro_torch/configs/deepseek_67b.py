"""deepseek-67b [dense]: llama-architecture dense model.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400  [arXiv:2401.02954]
"""
from repro_torch.configs.common import emt_preset, shrink
from repro_torch.models.config import ModelConfig


def build(emt=None) -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family="dense",
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=102400,
        rope_theta=1.0e4,
        emt=emt or emt_preset(),
    )


def smoke(emt=None) -> ModelConfig:
    return shrink(build(emt), num_layers=3)
