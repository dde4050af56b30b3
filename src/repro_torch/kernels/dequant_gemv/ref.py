"""Plain PyTorch version of the dequant-GEMV kernel (``repro``'s
``dequant_gemv_ref``): rebuild W_hat by indexing centroid-major
codebooks, then ``torch.matmul``."""
from __future__ import annotations

import torch


def dequant_gemv_ref(x: torch.Tensor, codebooks: torch.Tensor,
                     I: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, V, d), codebooks (C, k, d) centroid-major, I (C, V, N),
    scale (N,) -> y (M, N) fp32."""
    M, V, d = x.shape
    N = I.shape[-1]
    cb = codebooks.float()
    idx = I.long()
    w = cb[0][idx[0]]
    for c in range(1, cb.shape[0]):
        w = w + cb[c][idx[c]]                        # (V, N, d)
    w = w.permute(0, 2, 1).reshape(V * d, N)
    y = x.float().reshape(M, V * d) @ w
    return y * scale.float()[None, :]
