"""Plain PyTorch version of the OC-lookup kernel (``repro``'s
``oc_lookup_ref``): a ``torch.gather`` on int64-widened indices, the sum
over codebooks and rows of V, then the scale. It materializes the
(C, M, V, N) gather, so it is a check, not a path for every token."""
from __future__ import annotations

import torch


def oc_lookup_ref(O: torch.Tensor, I: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """O (C, M, V, k) fp32, I (C, V, N) int, scale (N,) -> y (M, N) fp32
    with y[m, j] = scale[j] sum_c sum_v O[c, m, v, I[c, v, j]]."""
    C, M, V, _ = O.shape
    N = I.shape[-1]
    g = torch.gather(O.float(), 3, I.long()[:, None].expand(C, M, V, N))
    return g.sum(dim=(0, 2)) * scale.float()[None, :]
