"""The EVA lookup kernels' summation order in plain torch, for the tests
that hold ``fused_vq_matmul`` and ``oc_lookup`` (which share
``csrc/eva_lookup.cuh``) to it."""
from __future__ import annotations

import torch


def lookup_in_kernel_order(O: torch.Tensor, I: torch.Tensor,
                           scale: torch.Tensor, tiles) -> torch.Tensor:
    """The lookup kernels' summation order in plain torch, for a launch
    shape ``tiles`` (``tiles.LookupTiles``): y (M, N) fp32 with
    y[m, j] = scale[j] sum_c sum_v O[c, m, v, I[c, v, j]], summed as the
    CUDA kernels sum it. Split p (cluster p // cs, rank p % cs) walks
    slabs [p*sps, (p+1)*sps) of ``vl`` rows; lane l of a column group
    adds, slab by slab and codebook by codebook, the entries of row
    slab*vl + l (rows past V add nothing). The ``vl`` lane partials meet
    in an xor butterfly (offsets vl/2 ... 1; fp32 addition commutes, so
    every lane of a pair computes the same sum), the ``cs`` CTAs of a
    cluster in rank order, the clusters in order, then the scale."""
    C, M, V, _ = O.shape
    N = I.shape[-1]
    vl, sps, cs, groups = tiles.vl, tiles.slabs_per_split, tiles.cs, tiles.groups
    splits = cs * groups
    O = O.float()
    lanes = torch.arange(vl)
    part = torch.zeros((splits, vl, M, N), dtype=torch.float32)
    for s in range(sps):
        v = (torch.arange(splits)[:, None] * sps + s) * vl + lanes[None, :]
        live = (v < V)[:, :, None, None]
        v = v.clamp(max=V - 1)
        for c in range(C):
            idx = I[c][v].long()                              # (splits, vl, N)
            rows = O[c][:, v].permute(1, 2, 0, 3)             # (splits, vl, M, k)
            term = torch.gather(rows, 3, idx[:, :, None, :].expand(-1, -1, M, -1))
            part = part + torch.where(live, term, torch.zeros_like(term))
    o = vl // 2
    while o:
        part = part + part[:, lanes ^ o]
        o //= 2
    part = part[:, 0].reshape(groups, cs, M, N)
    y = torch.zeros((groups, M, N), dtype=torch.float32)
    for r in range(cs):
        y = y + part[:, r]
    if groups > 1:
        acc = torch.zeros((M, N), dtype=torch.float32)
        for g in range(groups):
            acc = acc + y[g]
        y = acc[None]
    return y[0] * scale.float()[None, :]
