"""Plain PyTorch version of the INT8 GEMM kernel (``repro``'s
``int8_gemm_ref``): an exact integer product, then ``(acc * xs) * ws``
in fp32."""
from __future__ import annotations

import torch

from repro_torch.core.ops import int8_dot


def int8_gemm_ref(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
                  ws: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8, wq (K, N) int8, xs (M, 1), ws (1, N) -> (M, N) fp32."""
    return int8_dot(xq, wq).float() * xs.float() * ws.float()
