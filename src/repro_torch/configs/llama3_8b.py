"""Llama-3-8B — GQA, 128k vocab [arXiv:2407.21783].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    vq_C=2,
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=448,
    vocab_size=512,
    rope_theta=500000.0,
    vq_C=2,
)
