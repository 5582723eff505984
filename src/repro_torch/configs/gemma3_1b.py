"""gemma3-1b [dense]: 5:1 local:global attention, 262k vocab.

26L d_model=1152 4H (MQA kv=1) d_ff=6912 vocab=262144  [hf:google/gemma-3-1b-pt]
head_dim=256, sliding window 512, tied embeddings scaled by sqrt(d).
"""
from repro_torch.configs.common import emt_preset, shrink
from repro_torch.models.config import ModelConfig


def build(emt=None) -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        num_layers=26,
        d_model=1152,
        num_heads=4,
        num_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab_size=262144,
        layer_pattern=("local", "local", "local", "local", "local", "global"),
        sliding_window=512,
        rope_theta=1.0e6,
        qk_norm=True,
        tie_embeddings=True,
        embed_scale=True,
        act="gelu_tanh",
        emt=emt or emt_preset(),
    )


def smoke(emt=None) -> ModelConfig:
    return shrink(build(emt))
