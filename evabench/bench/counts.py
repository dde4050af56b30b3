"""The yardstick's arithmetic: the chip's published peaks, and the
operations and bytes of a step and of a kernel call, counted from the
configuration's shapes (never from the port's code).

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full power limit of 700 W.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

BF16_FLOPS = 989e12          # tensor cores, bf16 and fp16
FP32_FLOPS = 67e12           # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3

# VQ layout of every block linear: C codebooks of 2^n centroids over d
# vectors, uint8 indices, fp32 codebooks and per-column fp32 scales
VQ_C, VQ_D, VQ_N = 2, 8, 8


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> Tuple[float, str]:
    """The least time of a call at the data-sheet rates, and which of the
    two bounds it (a frozen copy of ``chip_smoke.bound_ms``)."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def linears(cfg: Dict) -> List[Tuple[str, int, int]]:
    """(name, K, N) of a dense GQA layer's four VQ linears, as the port
    groups them (wq|wk|wv, gate|up)."""
    d, q = cfg["hidden_size"], cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    ff = cfg["intermediate_size"]
    return [("wqkv", d, q + 2 * kv), ("wo", q, d), ("gu", d, 2 * ff),
            ("down", ff, d)]


def vq_bytes(K: int, N: int, C: int = VQ_C) -> int:
    """Indices, codebooks and scales of one VQ linear, as stored."""
    return C * (K // VQ_D) * N + C * VQ_D * 2 ** VQ_N * 4 + N * 4


def b1_bound_ms(M: int, K: int, N: int, C: int = VQ_C) -> Tuple[float, str]:
    """``fused_vq_matmul`` on fp32 x (M, K), as ``chip_smoke.check_b1``
    counts it: x, the indices, codebooks and scales, y; the products
    with the codebooks and the lookups' adds at the fp32 rate."""
    V = K // VQ_D
    nbytes = M * K * 4 + C * V * N + C * VQ_D * 256 * 4 + N * 4 + M * N * 4
    flops = C * M * V * 256 * VQ_D * 2 + C * M * V * N + M * N
    return bound_ms(nbytes, flops, FP32_FLOPS)


def layer_bound_ms(cfg: Dict, M: int) -> float:
    """B1's bound over a decode layer's four VQ linears at M rows."""
    return sum(b1_bound_ms(M, K, N)[0] for _, K, N in linears(cfg))


# ---------------------------------------------------------------------------
# A whole step's least time (step_mfu)
# ---------------------------------------------------------------------------


def block_params(cfg: Dict) -> int:
    return cfg["num_hidden_layers"] * sum(K * N for _, K, N in linears(cfg))


def head_params(cfg: Dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def weight_bytes(cfg: Dict) -> int:
    """Every weight a step reads, as stored: the VQ linears, the bf16
    head (the tied embedding where the head is tied), the biases and the
    norms (counted at 4 bytes: an upper bound on a few kB)."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    vq = L * sum(vq_bytes(K, N) for _, K, N in linears(cfg))
    small = L * (2 * d + (q + 2 * kv if cfg.get("qkv_bias") else 0)
                 + (2 * cfg["head_dim"] if cfg.get("qk_norm") else 0)) + d
    return vq + 2 * head_params(cfg) + 4 * small


def kv_row_bytes(cfg: Dict) -> int:
    """One position's K and V rows over every layer, bf16."""
    return (cfg["num_hidden_layers"] * 2 * cfg["num_key_value_heads"]
            * cfg["head_dim"] * 2)


def attn_flops(cfg: Dict, attended: int) -> int:
    """Q.K and P.V of one query over ``attended`` positions, every layer."""
    return (cfg["num_hidden_layers"] * 2 * 2 * cfg["num_attention_heads"]
            * cfg["head_dim"] * attended)


def decode_least_s(cfg: Dict, attended: Sequence[int]) -> float:
    """One decode step over len(attended) lanes, lane i attending over
    attended[i] positions: the weights read once, each lane's cache rows
    read and its new row written; 2 x params a token and attention at
    the bf16 rate. Zero for no lane."""
    n = len(attended)
    if n == 0:
        return 0.0
    flops = (2 * (block_params(cfg) + head_params(cfg)) * n
             + sum(attn_flops(cfg, a) for a in attended))
    nbytes = (weight_bytes(cfg) + kv_row_bytes(cfg) * (sum(attended) + n)
              + n * cfg["hidden_size"] * 2)
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def prefill_least_s(cfg: Dict, tokens: int) -> float:
    """A prefill of ``tokens`` true prompt tokens: the block linears over
    every token, the head over the last (the one a user needs), causal
    attention; the weights read once and the cache rows written."""
    att = attn_flops(cfg, tokens * (tokens + 1) // 2)   # query i: i + 1
    flops = 2 * block_params(cfg) * tokens + 2 * head_params(cfg) + att
    nbytes = weight_bytes(cfg) + kv_row_bytes(cfg) * tokens
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def ticks_least_s(cfg: Dict, ticks: Iterable) -> float:
    """The least time of the engine ticks: each tick's prefills, then its
    one decode step (``Tick.prefills``: prompt lengths; ``Tick.attended``:
    positions each decoding lane attended over)."""
    return sum(sum(prefill_least_s(cfg, p) for p in t.prefills)
               + decode_least_s(cfg, t.attended) for t in ticks)
