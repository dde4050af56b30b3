"""KV-cache utilities for serving (``repro/serve/kvcache.py``, the
contiguous full-attention subset): convert the bucket-length cache that
prefill returns into a fixed-capacity decode cache. Positions between
the true prompt length and the bucket ride along unread: decode
overwrites slot ``len`` before attention unmasks it (``pos < len``).
Ring (windowed) and quantized caches are not ported yet (ROADMAP A9,
A12)."""
from __future__ import annotations

from typing import Any, Optional

import torch


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
    """Pad every attention cache node ({"k", "v", "len"}, time axis -3)
    to ``capacity``; ``true_len`` overwrites the ``len`` leaves (the
    prompt's real length inside its padded bucket)."""

    def walk(node):
        if isinstance(node, dict):
            if "k" in node and "v" in node and "len" in node:
                out = dict(node)
                for n in ("k", "v"):
                    out[n] = _pad_time(node[n], node[n].dim() - 3, capacity)
                if true_len is not None:
                    out["len"] = torch.full_like(node["len"], true_len)
                return out
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache)


def cache_bytes(cache: Any) -> int:
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return 0
