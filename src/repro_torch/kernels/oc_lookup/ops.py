"""Wrapper of the OC-lookup kernel (``csrc/oc_lookup.cu``), the two-kernel
EVA matmul ``eva_split_matmul`` and its plan backend ``eva_split``.

The split backend is the paper's architecture drawn at kernel
granularity, with no fusion: ``vq_gemm`` (B4) writes the full (C, M, V,
2^n) output codebook to device memory and ``oc_lookup`` (B5) gathers and
adds over it. Against the fused kernel (``eva_fused``) it pays one more
round trip of the output codebook and a second launch, priced as
``PlanCost.intermediate_bytes`` and ``launches``; the ranked Planner
decides per site which side wins (analytically the fused kernel; a
calibration fitted on the card may flip it).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel, which reads the uint8 index matrix as stored (never widened), or
the wrapper raises. A grouped family (``splits``) is a wider N.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import ops as core_ops
from repro_torch.core import plan as plan_mod
from repro_torch.core.vq import VQWeight
from repro_torch.kernels import build
from repro_torch.kernels.eva_lookup import tiles
from repro_torch.kernels.oc_lookup.ref import oc_lookup_ref
from repro_torch.kernels.vq_gemm.ops import vq_gemm

_NAME = "oc_lookup"
C_MAX = 4


def select_lookup_split(M: int, V: int, N: int, C: int, sm_count: int,
                        slots: Optional[Tuple[int, ...]] = None
                        ) -> tiles.LookupTiles:
    """The lookup kernel's launch shape: the fused kernel's tile model
    (``tiles.lookup_tiles``) without the recompute, so its shared memory
    holds no codebooks or x rows and a slab costs no FMAs."""
    return tiles.lookup_tiles(M, V, N, C, sm_count, False, slots)


def _operands(O: torch.Tensor, I: torch.Tensor, scale: torch.Tensor):
    """Launch shape, y, the split workspace, and the pointer and size
    arguments of the C entry points (the trace entry takes its stamps
    after the workspace)."""
    C, M, V, k = O.shape
    N = I.shape[-1]
    dev = O.device
    ok = (1 <= C <= C_MAX and k == 256 and O.dtype == torch.float32
          and O.is_contiguous() and O.data_ptr() % 16 == 0
          and I.dtype == torch.uint8 and I.is_contiguous()
          and tuple(I.shape) == (C, V, N)
          and scale.dtype == torch.float32 and scale.is_contiguous()
          and tuple(scale.shape) == (N,)
          and I.device == scale.device == dev)
    if not ok:
        raise ValueError(
            f"{_NAME}: the kernel takes a contiguous, 16-byte aligned fp32 "
            f"output codebook (C, M, V, 256) with 1..{C_MAX} codebooks, "
            f"contiguous uint8 (C, V, N) indices and an fp32 (N,) scale, all "
            f"on one device; got O {O.dtype} {tuple(O.shape)} on {dev}, "
            f"indices {I.dtype} {tuple(I.shape)} on {I.device}, scale "
            f"{scale.dtype} {tuple(scale.shape)} on {scale.device}")
    di = dev.index if dev.index is not None else torch.cuda.current_device()
    t = select_lookup_split(M, V, N, C, build.device_sm_count(di),
                            tiles.cluster_slots(_NAME, di, M, C, False))
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    ws = (torch.empty((t.groups, M, N), dtype=torch.float32, device=dev)
          if t.groups > 1 else None)
    ptrs = [O.data_ptr(), I.data_ptr(), scale.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None]
    ints = [M, V, N, C, t.bn, t.stages, t.cs, t.groups, t.slabs_per_split]
    return t, y, ws, ptrs, ints


def _launch(O: torch.Tensor, I: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    _, y, held, ptrs, ints = _operands(O, I, scale)
    fn = build.bind(_NAME, "oc_lookup_launch", 5, 9)
    with torch.cuda.device(y.device):
        build.check(fn(*ptrs, *ints, build.stream_of(y)), _NAME)
    oc_lookup.launches += 1
    return y


def run_variant(O: torch.Tensor, I: torch.Tensor, scale: torch.Tensor,
                variant: str):
    """Launch a timing-only variant of the kernel (``build.VARIANTS``) on
    CUDA tensors, as ``fused_vq_matmul.ops.run_variant`` does."""
    t, y, held, ptrs, ints = _operands(O, I, scale)
    v = build.variant_index(_NAME, variant)
    stream = build.stream_of(y)
    with torch.cuda.device(y.device):
        if variant != "trace":
            fn = build.bind(_NAME, "oc_lookup_launch", 5, 9, v)
            build.check(fn(*ptrs, *ints, stream), _NAME)
            return y
        stamps = torch.zeros((tiles.grid_ctas(t, *y.shape), 5),
                             dtype=torch.int64, device=y.device)
        fn = build.bind(_NAME, "oc_lookup_launch_traced", 6, 9, v)
        build.check(fn(*ptrs, stamps.data_ptr(), *ints, stream), _NAME)
    return y, stamps


def oc_lookup(O: torch.Tensor, I: torch.Tensor, scale: torch.Tensor, *,
              use_kernel: bool = True) -> torch.Tensor:
    """y (M, N) fp32 = scale * the lookup-and-add of output codebook O
    (C, M, V, k) by indices I (C, V, N). ``use_kernel=False`` runs the
    plain version on any device."""
    if use_kernel and O.is_cuda:
        return _launch(O, I, scale)
    if use_kernel and O.device.type != "cpu":
        raise ValueError(f"{_NAME}: no kernel for device {O.device}")
    return oc_lookup_ref(O, I, scale)


oc_lookup.launches = 0


def eva_split_matmul(x: torch.Tensor, vq: VQWeight, *,
                     out_dtype: Optional[torch.dtype] = None,
                     use_kernel: bool = True) -> torch.Tensor:
    """y = x @ W_hat as two kernels with the (C, M, V, 2^n) output
    codebook in device memory between them."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    O = vq_gemm(x, vq.codebooks, use_kernel=use_kernel)
    y = oc_lookup(O, vq.idx, vq.scale, use_kernel=use_kernel)
    return y.reshape(*lead, vq.N).to(out_dtype)


# ---------------------------------------------------------------------------
# Plan backend: eva_split competes with eva_fused at every decode VQ site
# ---------------------------------------------------------------------------


def _match_eva_split(spec: plan_mod.LinearSpec,
                     policy: plan_mod.PlanPolicy) -> bool:
    # impl="cuda" only, and epilogue "auto" (any other stays eva_fused's
    # error), as the reference's eva_split_pallas
    return (spec.kind == "vq" and policy.vq_mode == "eva"
            and policy.impl == "cuda" and policy.epilogue == "auto")


def _plan_eva_split(spec: plan_mod.LinearSpec,
                    policy: plan_mod.PlanPolicy) -> plan_mod.MatmulPlan:
    out_dt = getattr(torch, spec.out_dtype)

    def run(x, vq):
        return eva_split_matmul(x, vq, out_dtype=out_dt)

    # the reference's terms: one launch per kernel (the lookup's split
    # reduce is not counted, so rankings compare one to one with it) and
    # the output codebook written and read back
    oc_bytes = 4 * spec.C * spec.M * spec.V * spec.k
    cost = plan_mod.PlanCost(
        macs=core_ops.vq_gemm_macs(spec.M, spec.K,
                                   max(spec.k.bit_length() - 1, 0), spec.C,
                                   spec.d),
        lookup_adds=core_ops.epilogue_adds(spec.M, spec.K, spec.N, spec.C,
                                           spec.d),
        weight_bytes=plan_mod.vq_weight_bytes(spec),
        intermediate_bytes=2 * oc_bytes,
        launches=2)
    return plan_mod.MatmulPlan("eva_split", spec, policy, (), cost, run)


plan_mod.register_backend("eva_split", _match_eva_split, _plan_eva_split)
