"""xLSTM-125M — alternating mLSTM/sLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H vocab=50304, d_ff=0 (projections live in the blocks).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="xlstm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    xlstm_pattern=("mlstm", "slstm"),
    vq_C=2,
)

SMOKE = ModelConfig(
    name="xlstm-125m-smoke",
    family="xlstm",
    num_layers=2,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    head_dim=32,
    d_ff=0,
    vocab_size=512,
    xlstm_pattern=("mlstm", "slstm"),
    vq_C=2,
)
