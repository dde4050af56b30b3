"""Wrapper of the VQ-GEMM kernel (``csrc/vq_gemm.cu``): the output
codebook O (C, M, V, 2^n) of EVA's first step, materialized in device
memory for ``oc_lookup`` — the first half of the two-kernel ``eva_split``
backend (registered from ``kernels/oc_lookup/ops.py``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or the wrapper raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.vq_gemm.ref import vq_gemm_ref

_NAME = "vq_gemm"


def _launch(x_flat: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    MV, d = x_flat.shape
    C = codebooks.shape[0]
    dev = x_flat.device
    ok = (d == 8 and codebooks.dtype == torch.float32
          and codebooks.is_contiguous() and tuple(codebooks.shape[1:]) == (8, 256)
          and codebooks.device == dev)
    if not ok:
        raise ValueError(
            f"{_NAME}: the kernel takes x with K a multiple of 8 and "
            f"contiguous fp32 (C, 8, 256) codebooks on x's device; got "
            f"vectors of {d}, codebooks {codebooks.dtype} "
            f"{tuple(codebooks.shape)} on {codebooks.device}")
    O = torch.empty((C, MV, 256), dtype=torch.float32, device=dev)
    fn = build.bind(_NAME, "vq_gemm_launch", 3, 2)
    with torch.cuda.device(dev):
        err = fn(x_flat.data_ptr(), codebooks.data_ptr(), O.data_ptr(), MV, C,
                 build.stream_of(x_flat))
    build.check(err, _NAME)
    vq_gemm.launches += 1
    return O


def vq_gemm(x: torch.Tensor, codebooks: torch.Tensor, *,
            use_kernel: bool = True) -> torch.Tensor:
    """The output codebook O (C, M, V, k) fp32 of activations x (..., K)
    against codebooks (C, d, k), M = x.numel() // K, V = K // d.
    ``use_kernel=False`` runs the plain version on any device."""
    C, d, k = codebooks.shape
    K = x.shape[-1]
    if K % d:
        raise ValueError(f"{_NAME}: K={K} is not a multiple of d={d}")
    V, M = K // d, x.numel() // K
    x_flat = x.reshape(M * V, d).float().contiguous()
    if use_kernel and x_flat.is_cuda:
        O = _launch(x_flat, codebooks)
    elif use_kernel and x_flat.device.type != "cpu":
        raise ValueError(f"{_NAME}: no kernel for device {x_flat.device}")
    else:
        O = vq_gemm_ref(x_flat, codebooks)
    return O.reshape(C, M, V, k)


vq_gemm.launches = 0
