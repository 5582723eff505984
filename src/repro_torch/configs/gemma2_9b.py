"""gemma2-9b [dense]: alternating local/global attention, logit soft-caps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000  [arXiv:2408.00118]
head_dim=256, sliding window 4096, attn softcap 50, final softcap 30.
"""
from repro_torch.configs.common import emt_preset, shrink
from repro_torch.models.config import ModelConfig


def build(emt=None) -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        layer_pattern=("local", "global"),
        sliding_window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        rope_theta=1.0e4,
        tie_embeddings=True,
        embed_scale=True,
        act="gelu_tanh",
        emt=emt or emt_preset(),
    )


def smoke(emt=None) -> ModelConfig:
    return shrink(build(emt))
