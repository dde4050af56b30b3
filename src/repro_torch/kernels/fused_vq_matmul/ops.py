"""Wrapper of the fused EVA matmul kernel (``csrc/fused_vq_matmul.cu``)
and its plan backend ``eva_fused`` — the decode path of every VQ linear
unless a calibration ranks the two-kernel ``eva_split`` below it.

Accepts activations of any leading shape and a VQWeight. CPU tensors take
the plain version (``ref.py``); CUDA tensors launch the kernel, which
reads the uint8 index matrix as stored (never widened), or the wrapper
raises. ``select_split`` is the kernel's launch shape
(``eva_lookup/tiles.py``: column tile, index stages, the V splits summed
in a thread-block cluster and, where a cluster cannot fill the card, by
a second launch).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import ops as core_ops
from repro_torch.core import plan as plan_mod
from repro_torch.core.vq import VQWeight
from repro_torch.kernels import build
from repro_torch.kernels.eva_lookup import tiles
from repro_torch.kernels.fused_vq_matmul.ref import fused_vq_matmul_ref

_NAME = "fused_vq_matmul"


def select_split(M: int, V: int, N: int, C: int, sm_count: int,
                 slots: Optional[Tuple[int, ...]] = None) -> tiles.LookupTiles:
    """The kernel's launch shape (``tiles.lookup_tiles`` with the output
    codebook recomputed in the kernel): column tile, index stages,
    cluster size and clusters per tile, slabs per CTA."""
    return tiles.lookup_tiles(M, V, N, C, sm_count, True, slots)


def _operands(X: torch.Tensor, vq: VQWeight):
    """Launch shape, y, the tensors the launch reads that the caller does
    not hold (x realigned, the split workspace), and the pointer and
    size arguments of the C entry points (the trace entry takes its
    stamps after the workspace)."""
    build.check_vq_operands(_NAME, X, vq)
    M, V, _ = X.shape
    C, N, dev = vq.C, vq.N, X.device
    if X.data_ptr() % 16:
        X = X.clone()                  # the kernel stages x rows 16 bytes at a time
    di = dev.index if dev.index is not None else torch.cuda.current_device()
    t = select_split(M, V, N, C, build.device_sm_count(di),
                     tiles.cluster_slots(_NAME, di, M, C, True))
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    ws = (torch.empty((t.groups, M, N), dtype=torch.float32, device=dev)
          if t.groups > 1 else None)
    ptrs = [X.data_ptr(), vq.codebooks.data_ptr(), vq.idx.data_ptr(),
            vq.scale.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None]
    ints = [M, V, N, C, t.bn, t.stages, t.cs, t.groups, t.slabs_per_split]
    return t, y, (X, ws), ptrs, ints


def _launch(X: torch.Tensor, vq: VQWeight) -> torch.Tensor:
    _, y, held, ptrs, ints = _operands(X, vq)
    fn = build.bind(_NAME, "fused_vq_matmul_launch", 6, 9)
    with torch.cuda.device(y.device):
        build.check(fn(*ptrs, *ints, build.stream_of(y)), _NAME)
    fused_vq_matmul.launches += 1
    return y


def run_variant(x: torch.Tensor, vq: VQWeight, variant: str):
    """Launch a timing-only variant of the kernel (``build.VARIANTS``) on
    CUDA tensors; it counts no launch. Returns y (wrong by design except
    for "trace"), and for "trace" also the (CTAs, 5) int64 %globaltimer
    stamps (ns) of each CTA: entry, slab 0 landed, slab loop done, first
    cluster barrier, exit."""
    X = x.reshape(-1, vq.V, vq.d).float().contiguous()
    t, y, held, ptrs, ints = _operands(X, vq)
    v = build.variant_index(_NAME, variant)
    stream = build.stream_of(y)
    with torch.cuda.device(y.device):
        if variant != "trace":
            fn = build.bind(_NAME, "fused_vq_matmul_launch", 6, 9, v)
            build.check(fn(*ptrs, *ints, stream), _NAME)
            return y
        stamps = torch.zeros((tiles.grid_ctas(t, *y.shape), 5),
                             dtype=torch.int64, device=y.device)
        fn = build.bind(_NAME, "fused_vq_matmul_launch_traced", 7, 9, v)
        build.check(fn(*ptrs, stamps.data_ptr(), *ints, stream), _NAME)
    return y, stamps


def fused_vq_matmul(x: torch.Tensor, vq: VQWeight, *,
                    out_dtype: Optional[torch.dtype] = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """y = x @ W_hat through the output-codebook lookup.

    ``use_kernel=False`` runs the plain version on any device (the
    reference of a run on the card); otherwise a CUDA input launches the
    kernel and a CPU input runs the plain version."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    M = x.numel() // vq.K
    X = x.reshape(M, vq.V, vq.d).float().contiguous()
    if use_kernel and X.is_cuda:
        y = _launch(X, vq)
    elif use_kernel and X.device.type != "cpu":
        raise ValueError(f"{_NAME}: no kernel for device {X.device}")
    else:
        y = fused_vq_matmul_ref(X, vq)
    return y.reshape(*lead, vq.N).to(out_dtype)


fused_vq_matmul.launches = 0


def _match_eva_fused(spec: plan_mod.LinearSpec,
                     policy: plan_mod.PlanPolicy) -> bool:
    # the kernel's backend, under impl="cuda" only (as the reference's
    # eva_fused_pallas matches impl="pallas" only); impl="torch" runs the
    # plain epilogues of core/plan.py
    return (spec.kind == "vq" and policy.vq_mode == "eva"
            and policy.impl == "cuda")


def _plan_eva_fused(spec: plan_mod.LinearSpec,
                    policy: plan_mod.PlanPolicy) -> plan_mod.MatmulPlan:
    if policy.epilogue != "auto":
        raise ValueError(
            "impl='cuda' always runs the EVA kernels; epilogue="
            f"{policy.epilogue!r} does not apply")
    out_dt = getattr(torch, spec.out_dtype)

    def run(x, vq):
        return fused_vq_matmul(x, vq, out_dtype=out_dt)

    cost = plan_mod.PlanCost(
        macs=core_ops.vq_gemm_macs(spec.M, spec.K,
                                   max(spec.k.bit_length() - 1, 0), spec.C,
                                   spec.d),
        lookup_adds=core_ops.epilogue_adds(spec.M, spec.K, spec.N, spec.C,
                                           spec.d),
        weight_bytes=plan_mod.vq_weight_bytes(spec))
    return plan_mod.MatmulPlan("eva_fused", spec, policy, (), cost, run)


plan_mod.register_backend("eva_fused", _match_eva_fused, _plan_eva_fused)
