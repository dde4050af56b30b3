"""Plain PyTorch versions of the dequant-GEMV kernel: ``dequant_gemv_ref``
(``repro``'s ``dequant_gemv_ref``: rebuild W_hat by indexing
centroid-major codebooks, then ``torch.matmul``), and
``dequant_gemv_split_ref``, the kernel's split-precision arithmetic
(bf16 hi/lo parts, exact products summed in fp32)."""
from __future__ import annotations

import torch


def _rebuild(codebooks: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """W_hat (V*d, N) fp32, summed over the codebooks in c order."""
    cb = codebooks.float()
    idx = I.long()
    w = cb[0][idx[0]]
    for c in range(1, cb.shape[0]):
        w = w + cb[c][idx[c]]                        # (V, N, d)
    V, N, d = w.shape
    return w.permute(0, 2, 1).reshape(V * d, N)


def dequant_gemv_ref(x: torch.Tensor, codebooks: torch.Tensor,
                     I: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, V, d), codebooks (C, k, d) centroid-major, I (C, V, N),
    scale (N,) -> y (M, N) fp32."""
    M, V, d = x.shape
    y = x.float().reshape(M, V * d) @ _rebuild(codebooks, I)
    return y * scale.float()[None, :]


def _hi_lo(t: torch.Tensor):
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def dequant_gemv_split_ref(x: torch.Tensor, codebooks: torch.Tensor,
                           I: torch.Tensor, scale: torch.Tensor
                           ) -> torch.Tensor:
    """What csrc/dequant_gemv.cu computes: each rebuilt fp32 weight split
    as w_hi = bf16(w), w_lo = bf16(w - w_hi); y = x.w_hi + x.w_lo for
    bf16 x, and y = x_hi.w_hi + x_hi.w_lo + x_lo.w_hi for fp32 x split
    the same way; products of bf16 values (exact in fp32) summed in fp32.
    Same arguments as ``dequant_gemv_ref``."""
    M, V, d = x.shape
    w_hi, w_lo = _hi_lo(_rebuild(codebooks, I))
    xf = x.reshape(M, V * d)
    if xf.dtype == torch.bfloat16:
        xb = xf.float()
        y = xb @ w_hi + xb @ w_lo
    else:
        x_hi, x_lo = _hi_lo(xf.float())
        y = x_hi @ w_hi + x_hi @ w_lo + x_lo @ w_hi
    return y * scale.float()[None, :]
