"""Plain PyTorch version of the VQ-GEMM kernel (``repro``'s
``vq_gemm_ref``): the output codebook by ``einsum``."""
from __future__ import annotations

import torch


def vq_gemm_ref(x_flat: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x_flat (MV, d), codebooks (C, d, k) -> O (C, MV, k) fp32."""
    return torch.einsum("md,cdk->cmk", x_flat.float(), codebooks.float())
