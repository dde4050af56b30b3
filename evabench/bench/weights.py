"""The model's weights, drawn from the seed on the device in a few large
calls, in the types they are served in. Both sides take these tensors:
``bench.port`` wraps them (views, no copies) in the port's param tree,
and the plain reference rebuilds its dense weights from them.

Layout, for a dense GQA configuration of L layers (names are the
configuration file's ``run`` keys)::

    embed       (vocab, d) bf16          N(0, 1); N(0, 1) / sqrt(d) when tied
    head        (d, vocab) bf16          N(0, 1) / sqrt(d); None when tied
    final_norm  (d,)                     1 + 0.1 N(0, 1)
    attn_norm, mlp_norm (L, d)           1 + 0.1 N(0, 1)
    q_norm, k_norm      (L, head_dim)    1 + 0.1 N(0, 1)   (qk_norm only)
    qkv_bias    (L, q + 2 kv) fp32       0.5 N(0, 1)       (qkv_bias only)
    wqkv, wo, gu, down: {"idx": (L, C, K/d, N) uint8 uniform,
                         "codebooks": (L, C, d, 256) fp32 N(0, 1/(K C)),
                                      wo and down N(0, 1/(2 L K C)),
                         "scale": (L, N) fp32 uniform on [0.5, 1.5)}

A weight's column j is ``scale[j] * concat_v(sum_c codebooks[c, :,
idx[c, v, j]])``. The norms are bf16 where the port serves them so (a
leaf of at least 65536 elements over its layers), fp32 otherwise.

A random model has to be conditioned as a trained one is, or the
correctness check cannot tell bf16 rounding from a fault: with the
embedding at 0.02, a token's own signal in the residual stream is as
small as the bf16 rounding of the stream, and on some seeds a plain bf16
computation of qwen2-72b's 80 layers lands several logits from the fp32
one, as far as fp8 does on others (``PERF.md``, the correctness check).
So an untied embedding is drawn at unit scale (a tied one is the head,
and is drawn as a head), and the two projections that write into the
residual stream (``wo``, ``down``) 1/sqrt(2 L) smaller, as GPT-2
initializes them.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from bench.counts import VQ_C, VQ_D, VQ_N, linears

# the port's rule for a dense leaf's serving type: bf16 from this many
# elements over the layers that stack it
BF16_MIN_SIZE = 65536
# the linears whose outputs are added to the residual stream
RESIDUAL_WRITERS = ("wo", "down")


def norm_dtype(numel: int, layers: int = 1) -> torch.dtype:
    return torch.bfloat16 if numel * layers >= BF16_MIN_SIZE else torch.float32


def draw(cfg: Dict, seed: int, device: Any) -> Dict[str, Any]:
    """Every weight of ``cfg`` from ``seed``, on ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    L, d, hd = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["head_dim"]
    vocab = cfg["vocab_size"]

    def gains(*shape):
        dt = norm_dtype(shape[-1], shape[0] if len(shape) > 1 else 1)
        t = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (1.0 + 0.1 * t).to(dt)

    w: Dict[str, Any] = {}
    with torch.no_grad():
        emb_std = (1.0 / math.sqrt(d) if cfg["tie_word_embeddings"]
                   else 1.0)
        w["embed"] = (torch.randn((vocab, d), generator=g, device=dev,
                                  dtype=torch.bfloat16) * emb_std)
        w["head"] = None
        if not cfg["tie_word_embeddings"]:
            w["head"] = torch.randn((d, vocab), generator=g, device=dev,
                                    dtype=torch.bfloat16) / math.sqrt(d)
        w["final_norm"] = gains(d)
        w["attn_norm"] = gains(L, d)
        w["mlp_norm"] = gains(L, d)
        if cfg["qk_norm"]:
            w["q_norm"] = gains(L, hd)
            w["k_norm"] = gains(L, hd)
        for name, K, N in linears(cfg):
            idx = torch.empty((L, VQ_C, K // VQ_D, N), dtype=torch.uint8,
                              device=dev).random_(0, 2 ** VQ_N, generator=g)
            std = 1.0 / math.sqrt(K * VQ_C)
            if name in RESIDUAL_WRITERS:
                std /= math.sqrt(2 * L)
            cb = torch.randn((L, VQ_C, VQ_D, 2 ** VQ_N), generator=g,
                             device=dev) * std
            scale = torch.rand((L, N), generator=g, device=dev) + 0.5
            w[name] = {"idx": idx, "codebooks": cb, "scale": scale}
            if name == "wqkv" and cfg["qkv_bias"]:
                w["qkv_bias"] = 0.5 * torch.randn((L, N), generator=g,
                                                  device=dev)
    return w


def nbytes(w: Any) -> int:
    if isinstance(w, torch.Tensor):
        return w.numel() * w.element_size()
    if isinstance(w, dict):
        return sum(nbytes(v) for v in w.values())
    return 0
