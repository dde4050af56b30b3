"""Matmul formulations reached by the serving path (the subset of
``repro/core/ops.py`` this slice needs).

  fp_matmul       : dense matmul (the dense ``lm_head``).
  dequant_matmul  : conventional VQ — reconstruct W_hat, then matmul (the
                    plain formulation every VQ kernel is held against).

The EVA formulation itself lives with its kernel
(``kernels/fused_vq_matmul``); the four jnp epilogues of the reference
(direct/flat/blocked/recon) are not ported (ROADMAP A3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.vq import VQWeight, dequantize


def fp_matmul(x: torch.Tensor, w: torch.Tensor, *,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense y = x @ w. ``torch.matmul`` accumulates in fp32; a bf16
    product is rounded to bf16 before the cast to ``out_dtype`` (the
    reference keeps the fp32 accumulator — equal at fp32)."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x, w).to(out_dtype)


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
