"""Llama-3.2-Vision-11B — 40L GQA decoder with gated cross-attention image
layers every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision]. Vision tower
stubbed (the prefill takes patch embeddings).

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_period=5,
    rope_theta=500000.0,
    vq_C=2,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-smoke",
    family="vision",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    cross_attn_period=2,
    vq_C=2,
)
