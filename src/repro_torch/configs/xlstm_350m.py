"""xlstm-350m [ssm]: sLSTM + mLSTM blocks (xLSTM[7:1]).

24L d_model=1024 4H d_ff=0 vocab=50304  [arXiv:2405.04517]
Blocks carry their own projections (d_ff=0: no separate FFN).
"""
from repro_torch.configs.common import emt_preset, shrink
from repro_torch.models.config import ModelConfig


def build(emt=None) -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        layer_pattern=("mlstm",) * 7 + ("slstm",),     # 7:1
        tie_embeddings=True,
        emt=emt or emt_preset(),
    )


def smoke(emt=None) -> ModelConfig:
    return shrink(build(emt), num_layers=4,
                  layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"))
