"""VQ weights: additive multi-codebook quantized matrices (the weight half
of ``repro/core/vq.py``).

Terminology follows the paper (Tbl. II):
  W      : (K, N) weight matrix
  d      : vector dimension (default 8)
  n      : index bit-width (default 8 -> 2^n = 256 centroids)
  C      : number of additive codebooks
  V      : K // d, height of the index matrix
  I      : (C, V, N) uint8 weight-index matrix
  B      : (C, d, 2^n) codebooks (centroid e is the column B[c, :, e])
  scale  : (N,) per-output-channel scale (fp32)

  W_hat[:, j] = scale[j] * concat_v( sum_c B[c, :, I[c, v, j]] )

A grouped projection family (Wq|Wk|Wv, W_gate|W_up) is ONE wide VQWeight
of shape (K, sum N_i) with one codebook set; ``splits`` records the member
widths (``()`` for an ordinary weight).

``fit_vq``/``kmeans`` and the KV half are not on the serving path and are
not ported yet (ROADMAP A2, A9).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass
class VQWeight:
    """Quantized (K, N) weight: tensors plus static metadata."""

    idx: torch.Tensor        # (C, V, N) uint8 (n <= 8) or int32 (n > 8)
    codebooks: torch.Tensor  # (C, d, 2^n) fp32
    scale: torch.Tensor      # (N,) fp32
    K: int = 0
    N: int = 0
    d: int = 8
    n: int = 8
    splits: Tuple[int, ...] = ()

    @property
    def C(self) -> int:
        return int(self.codebooks.shape[-3])

    @property
    def V(self) -> int:
        return self.K // self.d


def dequantize(vq: VQWeight) -> torch.Tensor:
    """Reconstruct W_hat (K, N) fp32 — the conventional-VQ baseline."""
    cb = vq.codebooks.float().transpose(-1, -2)        # (C, k, d)
    idx = vq.idx.long()                                # (C, V, N)
    C = cb.shape[0]
    # cents[c, v, j, :] = cb[c, idx[c, v, j], :]
    cents = torch.stack([cb[c][idx[c]] for c in range(C)])  # (C, V, N, d)
    cents = cents.sum(dim=0)                           # (V, N, d)
    V, N, d = cents.shape
    W = cents.permute(0, 2, 1).reshape(V * d, N)
    return W * vq.scale.float()[None, :]


def synthetic_vq(generator: torch.Generator, K: int, N: int, *, d: int = 8,
                 n: int = 8, C: int = 2, splits: Tuple[int, ...] = (),
                 device=None) -> VQWeight:
    """Random-but-valid VQ weight drawn on ``device`` from ``generator``
    (which must live on the same device): uniform indices, codebooks
    ~ N(0, 1/(K*C)) so W_hat has unit-ish variance, unit scales."""
    if splits and sum(splits) != N:
        raise ValueError(f"splits {splits} do not sum to N={N}")
    if K % d:
        raise ValueError(f"K={K} not divisible by d={d}")
    V, k = K // d, 2 ** n
    idx_dtype = torch.uint8 if n <= 8 else torch.int32
    idx = torch.randint(0, k, (C, V, N), generator=generator, device=device,
                        dtype=idx_dtype)
    codebooks = torch.randn((C, d, k), generator=generator, device=device,
                            dtype=torch.float32) / math.sqrt(K * C)
    scale = torch.ones((N,), dtype=torch.float32, device=device)
    return VQWeight(idx=idx, codebooks=codebooks, scale=scale, K=K, N=N, d=d,
                    n=n, splits=tuple(splits))


def split_grouped(vq: VQWeight) -> Tuple[VQWeight, ...]:
    """Slice a grouped VQWeight back into its members (shared codebooks,
    per-member index columns and scales)."""
    if not vq.splits:
        return (vq,)
    out = []
    lo = 0
    for width in vq.splits:
        hi = lo + width
        out.append(VQWeight(idx=vq.idx[..., lo:hi], codebooks=vq.codebooks,
                            scale=vq.scale[..., lo:hi], K=vq.K, N=width,
                            d=vq.d, n=vq.n))
        lo = hi
    return tuple(out)
