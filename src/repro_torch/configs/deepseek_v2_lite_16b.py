"""DeepSeek-V2-Lite (16B) — MLA (kv_lora=512) + MoE, 2 shared + 64 routed
experts top-6, expert d_ff=1408, first layer dense [arXiv:2405.04434; hf].

27L d_model=2048 16H vocab=102400.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,       # qk_nope 128 + qk_rope 64
    d_ff=10944,         # dense first-layer FFN
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10000.0,
    vq_C=2,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=48,
    d_ff=512,
    vocab_size=512,
    use_mla=True,
    kv_lora_rank=64,
    qk_nope_dim=32,
    qk_rope_dim=16,
    v_head_dim=32,
    num_experts=8,
    num_shared_experts=2,
    top_k=2,
    moe_d_ff=256,
    first_dense_layers=1,
    vq_C=2,
)
