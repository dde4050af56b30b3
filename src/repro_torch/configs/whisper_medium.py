"""Whisper-medium — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356]. 24L(enc)+24L(dec) d_model=1024 16H d_ff=4096
vocab=51865 (padded to 51968).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="whisper",
    is_encoder_decoder=True,
    encoder_layers=24,
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    vq_C=2,
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke",
    family="whisper",
    is_encoder_decoder=True,
    encoder_layers=2,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=500,
    vq_C=2,
)
