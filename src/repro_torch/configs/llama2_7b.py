"""LLaMA-2-7B — the paper's primary evaluation model [arXiv:2307.09288].
32L d_model=4096 32H (MHA) d_ff=11008 vocab=32000. VQ config: AQLM d=8,
n=8, C=2 (2 bits per weight)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    rope_theta=10000.0,
    vq_C=2,
)

SMOKE = ModelConfig(
    name="llama2-7b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=384,
    vocab_size=512,
    rope_theta=10000.0,
    vq_C=2,
)
