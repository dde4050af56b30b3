"""Plain PyTorch version of the fused EVA matmul (``repro``'s
``fused_vq_matmul_ref``): the direct epilogue of
``core.ops.eva_epilogue_exec`` (the output codebook O = x·B by ``einsum``,
the lookup by ``torch.gather`` on int64-widened indices), so that B1's
plain version and the plain decode step's direct epilogue are one
formula."""
from __future__ import annotations

import torch

from repro_torch.core import ops as core_ops
from repro_torch.core.vq import VQWeight


def fused_vq_matmul_ref(x: torch.Tensor, vq: VQWeight) -> torch.Tensor:
    """x (M, V, d) -> y (M, N) fp32 with
    y[m, j] = scale[j] sum_c sum_v O[c, m, v, I[c, v, j]]."""
    return core_ops.eva_epilogue_exec(x.reshape(x.shape[0], vq.K), vq,
                                      kind="direct", out_dtype=torch.float32)
