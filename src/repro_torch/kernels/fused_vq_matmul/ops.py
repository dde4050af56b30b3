"""Wrapper of the fused EVA matmul kernel (``csrc/fused_vq_matmul.cu``)
and its plan backend ``eva_fused`` — the decode path of every VQ linear
unless a calibration ranks the two-kernel ``eva_split`` below it.

Accepts activations of any leading shape and a VQWeight. CPU tensors take
the plain version (``ref.py``); CUDA tensors launch the kernel, which
reads the uint8 index matrix as stored (never widened), or the wrapper
raises. ``select_split`` is the kernel's tile model: the V-slab height
that fits the output-codebook slab in shared memory, and the number of
CTAs that split V so the grid fills the card.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import ops as core_ops
from repro_torch.core import plan as plan_mod
from repro_torch.core.vq import VQWeight
from repro_torch.kernels import build
from repro_torch.kernels.fused_vq_matmul.ref import fused_vq_matmul_ref

_NAME = "fused_vq_matmul"
BN = 1024                      # output columns per CTA (256 threads x 4)
MT_MAX = 8                     # x rows per CTA
SMEM_BUDGET = 96 * 1024        # output-codebook + x slab: 2 CTAs per SM
IDX_REGS = 32                  # index words a thread prefetches per slab
CTAS_PER_SM = 2


def select_split(M: int, V: int, N: int, C: int, sm_count: int,
                 k: int = 256, d: int = 8) -> Tuple[int, int, int]:
    """(bv, v_per_split, splits): the slab height whose O (C, mt, bv, k)
    plus x slab fit SMEM_BUDGET and whose C*bv index words fit the
    kernel's prefetch registers, and a V split that gives the grid about
    CTAS_PER_SM CTAs per SM. Every split covers ``v_per_split`` rows (a
    whole number of slabs) except possibly the last."""
    mt = min(M, MT_MAX)
    bv = max(1, min(IDX_REGS // C, V, SMEM_BUDGET // (4 * mt * (C * k + d))))
    slabs = -(-V // bv)
    tiles = -(-N // BN) * -(-M // MT_MAX)
    want = max(1, -(-CTAS_PER_SM * sm_count // tiles))
    splits = min(slabs, want)
    v_per_split = -(-slabs // splits) * bv
    return bv, v_per_split, -(-V // v_per_split)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(X: torch.Tensor, vq: VQWeight) -> torch.Tensor:
    build.check_vq_operands(_NAME, X, vq)
    M, V, _ = X.shape
    C, N, dev = vq.C, vq.N, X.device
    bv, vps, splits = select_split(M, V, N, C, _sm_count(dev.index or 0))
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    fn = build.bind(_NAME, "fused_vq_matmul_launch", 6, 7)
    with torch.cuda.device(dev):
        err = fn(X.data_ptr(), vq.codebooks.data_ptr(), vq.idx.data_ptr(),
                 vq.scale.data_ptr(), y.data_ptr(),
                 ws.data_ptr() if ws is not None else None,
                 M, V, N, C, bv, vps, splits, build.stream_of(X))
    build.check(err, _NAME)
    fused_vq_matmul.launches += 1
    return y


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
        y = fused_vq_matmul_ref(X, vq.codebooks, vq.idx, vq.scale)
    return y.reshape(*lead, vq.N).to(out_dtype)


fused_vq_matmul.launches = 0


def _match_eva_fused(spec: plan_mod.LinearSpec,
                     policy: plan_mod.PlanPolicy) -> bool:
    return spec.kind == "vq" and policy.vq_mode == "eva"


def _plan_eva_fused(spec: plan_mod.LinearSpec,
                    policy: plan_mod.PlanPolicy) -> plan_mod.MatmulPlan:
    out_dt = getattr(torch, spec.out_dtype)
    use_kernel = policy.impl == "cuda"

    def run(x, vq):
        return fused_vq_matmul(x, vq, out_dtype=out_dt, use_kernel=use_kernel)

    cost = plan_mod.PlanCost(
        macs=core_ops.vq_gemm_macs(spec.M, spec.K,
                                   max(spec.k.bit_length() - 1, 0), spec.C,
                                   spec.d),
        lookup_adds=core_ops.epilogue_adds(spec.M, spec.K, spec.N, spec.C,
                                           spec.d),
        weight_bytes=plan_mod.vq_weight_bytes(spec))
    return plan_mod.MatmulPlan("eva_fused", spec, policy, (), cost, run)


plan_mod.register_backend("eva_fused", _match_eva_fused, _plan_eva_fused)
