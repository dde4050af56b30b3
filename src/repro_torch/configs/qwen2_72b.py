"""Qwen2-72B — GQA with QKV bias [arXiv:2407.10671; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    vq_C=2,
)

SMOKE = ModelConfig(
    name="qwen2-72b-smoke",
    family="dense",
    num_layers=3,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=448,
    vocab_size=512,
    qkv_bias=True,
    rope_theta=1000000.0,
    vq_C=2,
)
