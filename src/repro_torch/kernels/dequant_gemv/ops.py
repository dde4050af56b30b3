"""Wrapper of the dequant-GEMV kernel (``csrc/dequant_gemv.cu``) and its
plan backend ``dequant`` — the prefill path of every VQ linear
(``PlanPolicy.resolve_vq_mode`` maps every mode but decode here).

CPU tensors take the plain version (``ref.py``, which takes the
codebooks centroid-major as the reference's oracle does); CUDA tensors
launch the kernel, which reads the codebooks as the VQ weight stores
them (C, d, 2^n) and the uint8 indices as stored, or the wrapper raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.vq import VQWeight
from repro_torch.kernels import build
from repro_torch.kernels.dequant_gemv.ref import dequant_gemv_ref

_NAME = "dequant_gemv"
TOKEN_TILES = (32, 64, 128, 256)   # tokens per CTA: wgmma's N
COLS_PER_CTA = 128                 # weight columns per CTA
ROWS_PER_STAGE = 8                 # index rows per K stage
MAX_K_SPLITS = 8


def launch_shape(M: int, V: int, N: int, sms: int) -> Tuple[int, int]:
    """(tokens per CTA, K splits) of a launch: the smallest token tile
    that holds M (tiles of 256 above), and, when the (N, M) tiles leave
    SMs idle, as many K splits as fit in one wave (two CTAs an SM for
    tiles of <= 64 tokens), each at least one stage deep."""
    T = next((t for t in TOKEN_TILES if M <= t), TOKEN_TILES[-1])
    tiles = -(-N // COLS_PER_CTA) * -(-M // T)
    stages = -(-V // ROWS_PER_STAGE)
    slots = sms * (2 if T <= 64 else 1)
    splits = max(1, min(MAX_K_SPLITS, slots // tiles, stages))
    per = -(-stages // splits)
    return T, -(-stages // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(X: torch.Tensor, vq: VQWeight, out_dtype: torch.dtype
            ) -> torch.Tensor:
    build.check_vq_operands(_NAME, X, vq)
    if (X.dtype not in (torch.bfloat16, torch.float32)
            or not X.is_contiguous() or X.data_ptr() % 16):
        raise ValueError(f"{_NAME}: the kernel takes contiguous, 16-byte "
                         f"aligned bfloat16 or float32 x; got {X.dtype}")
    M, V, _ = X.shape
    C, N, dev = vq.C, vq.N, X.device
    T, splits = launch_shape(M, V, N, _sm_count(dev.index))
    out_bf16 = out_dtype == torch.bfloat16
    y = torch.empty((M, N), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                    device=dev)
    x_f32 = X.dtype == torch.float32
    halves = (torch.empty((2, M, V * 8), dtype=torch.bfloat16, device=dev)
              if x_f32 else None)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    fn = build.bind(_NAME, "dequant_gemv_launch", 8, 8)
    with torch.cuda.device(dev):
        err = fn(X.data_ptr(), halves[0].data_ptr() if x_f32 else None,
                 halves[1].data_ptr() if x_f32 else None,
                 vq.codebooks.data_ptr(), vq.idx.data_ptr(),
                 vq.scale.data_ptr(), y.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 M, V, N, C, T, splits, int(x_f32), int(out_bf16),
                 build.stream_of(X))
    build.check(err, _NAME)
    dequant_gemv.launches += 1
    return y


def dequant_gemv(x: torch.Tensor, vq: VQWeight, *,
                 out_dtype: Optional[torch.dtype] = None,
                 use_kernel: bool = True) -> torch.Tensor:
    """y = x @ W_hat, rebuilding W_hat tile by tile. On the card x goes
    to the kernel in its own dtype (bf16 or fp32); ``use_kernel=False``
    runs the plain version on any device."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    M = x.numel() // vq.K
    X = x.reshape(M, vq.V, vq.d)
    if use_kernel and X.is_cuda:
        y = _launch(X.contiguous(), vq, out_dtype)
    elif use_kernel and X.device.type != "cpu":
        raise ValueError(f"{_NAME}: no kernel for device {X.device}")
    else:
        y = dequant_gemv_ref(X.float(), vq.codebooks.transpose(-1, -2),
                             vq.idx, vq.scale)
    return y.reshape(*lead, vq.N).to(out_dtype)


dequant_gemv.launches = 0


def _match_dequant(spec: plan_mod.LinearSpec,
                   policy: plan_mod.PlanPolicy) -> bool:
    return spec.kind == "vq" and policy.vq_mode == "dequant"


def _plan_dequant(spec: plan_mod.LinearSpec,
                  policy: plan_mod.PlanPolicy) -> plan_mod.MatmulPlan:
    out_dt = getattr(torch, spec.out_dtype)
    use_kernel = policy.impl == "cuda"

    def run(x, vq):
        return dequant_gemv(x, vq, out_dtype=out_dt, use_kernel=use_kernel)

    cost = plan_mod.PlanCost(macs=spec.M * spec.K * spec.N,
                             lookup_adds=spec.C * spec.V * spec.N * spec.d,
                             weight_bytes=plan_mod.vq_weight_bytes(spec))
    return plan_mod.MatmulPlan("dequant", spec, policy, (), cost, run)


plan_mod.register_backend("dequant", _match_dequant, _plan_dequant)
