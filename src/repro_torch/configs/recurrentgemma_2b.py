"""RecurrentGemma-2B — RG-LRU + local attention, pattern (rec, rec, attn)
[arXiv:2402.19427; hf]. 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, local window 2048.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="rglru",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    local_window=2048,
    rec_pattern=("rec", "rec", "attn"),
    d_rnn=2560,
    conv_width=4,
    rope_theta=10000.0,
    vq_C=2,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="rglru",
    num_layers=5,        # (rec, rec, attn) + 2 trailing rec
    d_model=128,
    num_heads=2,
    num_kv_heads=1,
    head_dim=64,
    d_ff=384,
    vocab_size=512,
    local_window=32,
    rec_pattern=("rec", "rec", "attn"),
    d_rnn=128,
    conv_width=4,
    vq_C=2,
)
