"""Wrapper of the dequant-GEMV kernel (``csrc/dequant_gemv.cu``) and its
plan backend ``dequant`` — the prefill path of every VQ linear
(``PlanPolicy.resolve_vq_mode`` maps every mode but decode here).

CPU tensors take the plain version (``ref.py``, which takes the
codebooks centroid-major as the reference's oracle does); CUDA tensors
launch the kernel, which reads the codebooks as the VQ weight stores
them (C, d, 2^n) and the uint8 indices as stored, or the wrapper raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.vq import VQWeight
from repro_torch.kernels import build
from repro_torch.kernels.dequant_gemv.ref import dequant_gemv_ref

_NAME = "dequant_gemv"


def _launch(X: torch.Tensor, vq: VQWeight) -> torch.Tensor:
    build.check_vq_operands(_NAME, X, vq)
    M, V, _ = X.shape
    C, N, dev = vq.C, vq.N, X.device
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    fn = build.bind(_NAME, "dequant_gemv_launch", 5, 4)
    with torch.cuda.device(dev):
        err = fn(X.data_ptr(), vq.codebooks.data_ptr(), vq.idx.data_ptr(),
                 vq.scale.data_ptr(), y.data_ptr(), M, V, N, C,
                 build.stream_of(X))
    build.check(err, _NAME)
    dequant_gemv.launches += 1
    return y


def dequant_gemv(x: torch.Tensor, vq: VQWeight, *,
                 out_dtype: Optional[torch.dtype] = None,
                 use_kernel: bool = True) -> torch.Tensor:
    """y = x @ W_hat, rebuilding W_hat tile by tile. ``use_kernel=False``
    runs the plain version on any device."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    M = x.numel() // vq.K
    X = x.reshape(M, vq.V, vq.d).float().contiguous()
    if use_kernel and X.is_cuda:
        y = _launch(X, vq)
    elif use_kernel and X.device.type != "cpu":
        raise ValueError(f"{_NAME}: no kernel for device {X.device}")
    else:
        y = dequant_gemv_ref(X, vq.codebooks.transpose(-1, -2), vq.idx,
                             vq.scale)
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
