"""llama3-405b [dense]: GQA, 128k vocab.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256  [arXiv:2407.21783]
"""
from repro_torch.configs.common import emt_preset, shrink
from repro_torch.models.config import ModelConfig


def build(emt=None) -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=5.0e5,
        emt=emt or emt_preset(),
    )


def smoke(emt=None) -> ModelConfig:
    return shrink(build(emt), num_layers=3)
