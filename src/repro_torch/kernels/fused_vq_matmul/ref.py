"""Plain PyTorch version of the fused EVA matmul (``repro``'s
``fused_vq_matmul_ref``): the output codebook O = x·B by ``einsum``, the
lookup by ``torch.gather`` on int64-widened indices."""
from __future__ import annotations

import torch


def fused_vq_matmul_ref(x: torch.Tensor, codebooks: torch.Tensor,
                        I: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, V, d), codebooks (C, d, k), I (C, V, N), scale (N,) ->
    y (M, N) fp32 with y[m, j] = scale[j] sum_c sum_v O[c, m, v, I[c, v, j]]."""
    O = torch.einsum("mvd,cdk->cmvk", x.float(), codebooks.float())
    C, M, V, _ = O.shape
    N = I.shape[-1]
    g = torch.gather(O, 3, I.long()[:, None].expand(C, M, V, N))
    return g.sum(dim=(0, 2)) * scale.float()[None, :]

