"""Matmul formulations reached by the serving path (the subset of
``repro/core/ops.py`` this slice needs).

  fp_matmul       : dense matmul (the dense ``lm_head``).
  quantize_int8   : symmetric per-slice int8 quantization.
  int8_matmul     : the INT8 prefill formulation (per-token int8
                    activations x per-channel int8 weights, exact integer
                    accumulation, fp dequant) — the plain version of the
                    ``int8_gemm`` kernel's wrapper.
  dequant_matmul  : conventional VQ — reconstruct W_hat, then matmul (the
                    plain formulation every VQ kernel is held against).

The EVA formulation itself lives with its kernel
(``kernels/fused_vq_matmul``); the four jnp epilogues of the reference
(direct/flat/blocked/recon) are not ported (ROADMAP A8).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.vq import VQWeight, dequantize


def fp_matmul(x: torch.Tensor, w: torch.Tensor, *,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense y = x @ w with fp32 accumulation, as the reference's. An fp32
    ``out_dtype`` over lower-precision operands returns the fp32
    accumulator itself, never a product rounded to x's dtype: on CUDA
    ``torch.mm(..., out_dtype=torch.float32)`` over the 2-D view of x
    (no upcast copy of w), on the CPU the product of both operands upcast
    to fp32 (exact upcasts; ``aten::mm.dtype`` has no CPU kernel). Every
    other case is ``torch.matmul`` cast to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    if out_dtype == torch.float32 and x.dtype != torch.float32:
        if x.is_cuda and w.dtype == x.dtype and w.dim() == 2:
            y = torch.mm(x.reshape(-1, x.shape[-1]), w,
                         out_dtype=torch.float32)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return torch.matmul(x.float(), w.float())
    return torch.matmul(x, w).to(out_dtype)


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization along ``axis``: returns
    (int8 q, fp32 scale with ``axis`` kept as 1). ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 (M, K) and (K, N) operands, as an
    integer-valued float64 tensor: every partial sum is bounded by
    127^2 * K < 2^53, so float64 accumulates exactly in any order (CUDA
    has no integer matmul, and an int8 ``torch.matmul`` would overflow)."""
    return torch.matmul(xq.double(), wq.double())


def int8_matmul(x: torch.Tensor, w: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """INT8 prefill path: per-token int8 activations x per-channel int8
    weights -> exact integer accumulation -> fp32 ``(acc * xs) * ws``."""
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    xq, xs = quantize_int8(x.reshape(-1, K), axis=-1)      # (M, K), (M, 1)
    wq, ws = quantize_int8(w, axis=0)                       # (K, N), (1, N)
    y = int8_dot(xq, wq).float() * xs * ws
    return y.reshape(*lead, w.shape[-1]).to(out_dtype)


def dequant_matmul(x: torch.Tensor, vq: VQWeight, *,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Conventional VQ baseline: materialize W_hat (K, N) fp32, then an
    fp32 matmul — the numerical oracle of the VQ kernels."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.float(), dequantize(vq)).to(out_dtype)


def split_grouped_outputs(y: torch.Tensor, vq: VQWeight
                          ) -> Tuple[torch.Tensor, ...]:
    """Slice a grouped-family output (y = x @ [W1|..|Wg]) into the
    members' outputs at the recorded split points (views, no copy)."""
    if not vq.splits:
        return (y,)
    return tuple(torch.split(y, list(vq.splits), dim=-1))


def vq_gemm_macs(M: int, K: int, n: int, C: int, d: int) -> int:
    """MACs of the VQ-GEMM stage O = X·B: (M*K/d) rows x 2^n cols x d
    depth, per codebook."""
    return C * M * (K // d) * (2 ** n) * d


def epilogue_adds(M: int, K: int, N: int, C: int, d: int) -> int:
    """Add-only lookup epilogue: one add per (m, v, j, c)."""
    return C * M * (K // d) * N
