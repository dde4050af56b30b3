"""Mixtral-8x22B — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]. 56L d_model=6144 48H (GQA kv=8) expert
d_ff=16384 vocab=32768, window 4096, rope theta 1e6.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    num_experts=8,
    top_k=2,
    moe_d_ff=16384,
    rope_theta=1000000.0,
    vq_C=2,
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    sliding_window=64,
    num_experts=4,
    top_k=2,
    moe_d_ff=256,
    vq_C=2,
)
