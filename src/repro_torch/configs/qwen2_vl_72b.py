"""qwen2-vl-72b [vlm]: M-RoPE, dynamic-resolution vision frontend (stubbed).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064  [arXiv:2409.12191]
The vision tower is a stub: the "embeds" input kind takes precomputed patch
embeddings (B, S, D); M-RoPE runs over (t, h, w) position-id streams.
"""
from repro_torch.configs.common import emt_preset, shrink
from repro_torch.models.config import ModelConfig


def build(emt=None) -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        rope_type="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1.0e6,
        input_kind="embeds",
        emt=emt or emt_preset(),
    )


def smoke(emt=None) -> ModelConfig:
    return shrink(build(emt))
