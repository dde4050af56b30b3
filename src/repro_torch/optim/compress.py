"""Gradient compression for the data-parallel all-reduce: int8 symmetric
quantization with a per-leaf fp32 scale and error feedback (EF-SGD;
``repro/optim/compress.py``).

Each rank quantizes its gradient leaf plus its residual to int8, keeps
the new residual (the quantization error, added back at the next step)
and contributes the dequantized values to a mean all-reduce over a
``torch.distributed`` process group. As in the reference, the wire
carries the dequantized values (no collective sums int8 payloads of
different scales); ``compression_ratio`` accounts the bytes an int8
payload and its scale would take.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import float_leaves, map_leaves


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, fp32 scale): scale = max|g| / 127 (at least 1e-12 / 127),
    q = round(g / scale) half to even, clipped to [-127, 127]."""
    absmax = torch.max(torch.abs(g))
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_psum(grads: Any, ef: Any, group: Optional[Any] = None
                  ) -> Tuple[Any, Any]:
    """Quantized mean all-reduce of ``grads`` over ``group`` (default: the
    world) with error feedback ``ef`` (this rank's residuals, fp32, the
    tree of ``grads``). Returns (reduced grads, new ef)."""
    n = dist.get_world_size(group)

    def one(g, e):
        g32 = g.float() + e
        q, scale = _quantize_leaf(g32)
        deq = q.float() * scale
        red = deq.clone()
        dist.all_reduce(red, group=group)
        return (red / n).to(g.dtype), g32 - deq   # residual kept locally

    out = map_leaves(one, grads, ef)
    pick = lambda i: map_leaves(lambda g, o: o[i], grads, out)
    return pick(0), pick(1)


def init_error_feedback(grads_spec: Any) -> Any:
    """fp32 zeros in the shape of every leaf of ``grads_spec``."""
    return map_leaves(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device), grads_spec)


def compression_ratio(grads: Any) -> float:
    """Bytes on the wire against fp32: an int8 payload and one fp32 scale
    a leaf."""
    leaves = float_leaves(grads)
    total = sum(x.numel() for x in leaves)
    return (total * 1 + len(leaves) * 4) / (total * 4)
