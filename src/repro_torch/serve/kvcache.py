"""KV-cache utilities for serving (``repro/serve/kvcache.py``, the
contiguous full-attention subset): quantize the fp cache that prefill
returns into the engine's compressed layout (``quantize_prefill_cache_int8``
for kv_bits=8, ``encode_prefill_cache`` for the KV-VQ kv_bits 4/2), then
pad it to a fixed-capacity decode cache. Positions between the true
prompt length and the bucket ride along unread: decode overwrites slot
``len`` before attention unmasks it (``pos < len``). Ring (windowed)
caches are not ported yet (ROADMAP A7)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.vq import KVQuantConfig, kv_encode
from repro_torch.models.common import _quantize_kv


def _pad_time(x: torch.Tensor, axis: int, capacity: int) -> torch.Tensor:
    S = x.shape[axis]
    if S == capacity:
        return x
    if S > capacity:
        raise ValueError(f"prefill length {S} exceeds capacity {capacity}")
    shape = list(x.shape)
    shape[axis] = capacity
    out = x.new_zeros(shape)
    out.narrow(axis, 0, S).copy_(x)
    return out


def pad_prefill_cache(cache: Any, capacity: int, *,
                      true_len: Optional[int] = None) -> Any:
    """Pad every attention cache node ({"k", "v", "len"}, time axis -3;
    its ``k_s``/``v_s`` scale leaves, time axis -2) to ``capacity``;
    ``true_len`` overwrites the ``len`` leaves (the prompt's real length
    inside its padded bucket)."""

    def walk(node):
        if isinstance(node, dict):
            if "k" in node and "v" in node and "len" in node:
                out = dict(node)
                for n in ("k", "v"):
                    out[n] = _pad_time(node[n], node[n].dim() - 3, capacity)
                for n in ("k_s", "v_s"):
                    if n in node:
                        out[n] = _pad_time(node[n], node[n].dim() - 2,
                                           capacity)
                if true_len is not None:
                    out["len"] = torch.full_like(node["len"], true_len)
                return out
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache)


def quantize_prefill_cache_int8(cache: Any) -> Any:
    """Quantize every fp attention node of a prefill cache into the int8
    ``k``/``v`` + bf16 ``k_s``/``v_s`` layout (kv_bits=8) by the rule
    decode appends use. Prefill runs in fp; the engine calls this before
    slot insertion, which would otherwise truncate rather than quantize."""

    def walk(node):
        if isinstance(node, dict):
            if ("k" in node and "v" in node and "len" in node
                    and node["k"].is_floating_point()):
                kq, ks = _quantize_kv(node["k"])
                vq, vs = _quantize_kv(node["v"])
                return {"k": kq, "v": vq, "k_s": ks, "v_s": vs,
                        "len": node["len"]}
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache)


def encode_prefill_cache(cache: Any, codebooks: Any,
                         kvq: KVQuantConfig) -> Any:
    """Encode an fp prefill cache into the KV-VQ layout: every attention
    node with codebooks becomes uint8 ``k``/``v`` indices and bf16
    ``k_s``/``v_s`` scales, layer by layer against its own codebooks.

    Args:
      cache: prefill cache tree ({"body": {"k": (L, B, S, Hk, hd), ...}}).
      codebooks: ``core.quantize.kv_codebook_tree(params)`` — {"body":
        {"k": (L, Hk, R, 256, vd), "v": ...}}.
      kvq: the KVQuantConfig (supplies the scale variant).

    Nodes already uint8, and nodes without codebooks, pass through.
    """

    def enc(x, cbs):
        pairs = [kv_encode(x[i], cbs[i], kvq.variant)
                 for i in range(x.shape[0])]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]).to(torch.bfloat16))

    def walk(node, cbs):
        if isinstance(node, dict):
            if "k" in node and "v" in node and "len" in node:
                if cbs is None or node["k"].dtype == torch.uint8:
                    return node
                k_idx, k_s = enc(node["k"], cbs["k"])
                v_idx, v_s = enc(node["v"], cbs["v"])
                return {"k": k_idx, "v": v_idx, "k_s": k_s, "v_s": v_s,
                        "len": node["len"]}
            return {k: walk(v, cbs.get(k) if isinstance(cbs, dict) else None)
                    for k, v in node.items()}
        return node

    return walk(cache, codebooks)


def cache_bytes(cache: Any) -> int:
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return 0
