"""seamless-m4t-medium [audio]: encoder-decoder multimodal backbone.

12L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206  [arXiv:2308.11596]
The speech front end is a stub: the encoder takes precomputed frame
embeddings; the decoder is a text decoder with cross attention.
"""
from repro_torch.configs.common import emt_preset, shrink
from repro_torch.models.config import ModelConfig


def build(emt=None) -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        num_layers=12,                 # decoder layers
        encoder_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,
        act="gelu",
        emt=emt or emt_preset(),
    )


def smoke(emt=None) -> ModelConfig:
    return shrink(build(emt), num_layers=2, head_dim=16)
