"""Wrapper of the VQ-GEMM kernel (``csrc/vq_gemm.cu``): the output
codebook O (C, M, V, 2^n) of EVA's first step, materialized in device
memory for ``oc_lookup`` — the first half of the two-kernel ``eva_split``
backend (registered from ``kernels/oc_lookup/ops.py``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or the wrapper raises. The kernel reads bf16 or fp32 x as stored
(a served bf16 x is one kernel, no cast); x of any other dtype is cast
to fp32 first. ``launch_shape`` is the kernel's grid.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.vq_gemm.ref import vq_gemm_ref

_NAME = "vq_gemm"
X_DTYPES = (torch.bfloat16, torch.float32)
ROWS_MAX = 256          # rows of M*V a CTA stages (vq_gemm.cu ROWS_MAX)


class VqGemmShape(NamedTuple):
    rows: int           # rows of M*V a CTA owns, for every codebook
    ctas: int


def launch_shape(MV: int, sm_count: int) -> VqGemmShape:
    """The kernel's grid: CTA b owns rows [b * rows, min(MV, (b + 1) *
    rows)) of M*V for every codebook, so its rows of one codebook are one
    contiguous region of O and x is read once for all C. One CTA an SM,
    more where a CTA would hold over ROWS_MAX rows; the codebook count
    sets only a CTA's work, not the split."""
    rows = min(ROWS_MAX, max(1, -(-MV // sm_count)))
    return VqGemmShape(rows, -(-MV // rows))


def _operands(x: torch.Tensor, codebooks: torch.Tensor):
    """O, and the pointer and size arguments of the C entry point."""
    if x.dtype not in X_DTYPES:
        x = x.float()
    C = codebooks.shape[0]
    dev = x.device
    ok = (x.shape[-1] % 8 == 0 and x.is_contiguous() and x.data_ptr() % 16 == 0
          and codebooks.dtype == torch.float32 and codebooks.is_contiguous()
          and codebooks.data_ptr() % 16 == 0
          and tuple(codebooks.shape[1:]) == (8, 256) and codebooks.device == dev)
    if not ok:
        raise ValueError(
            f"{_NAME}: the kernel takes contiguous, 16-byte aligned x with K a "
            f"multiple of 8 and contiguous, 16-byte aligned fp32 (C, 8, 256) "
            f"codebooks on x's device; got x {x.dtype} {tuple(x.shape)} "
            f"(contiguous {x.is_contiguous()}, address mod 16 = "
            f"{x.data_ptr() % 16}), codebooks {codebooks.dtype} "
            f"{tuple(codebooks.shape)} on {codebooks.device} (contiguous "
            f"{codebooks.is_contiguous()}, address mod 16 = "
            f"{codebooks.data_ptr() % 16})")
    MV = x.numel() // 8
    di = dev.index if dev.index is not None else torch.cuda.current_device()
    shape = launch_shape(MV, build.device_sm_count(di))
    O = torch.empty((C, MV, 256), dtype=torch.float32, device=dev)
    ptrs = [x.data_ptr(), codebooks.data_ptr(), O.data_ptr()]
    ints = [MV, C, shape.rows, int(x.dtype == torch.bfloat16)]
    return O, ptrs, ints


def _launch(x: torch.Tensor, codebooks: torch.Tensor, variant: int = 0
            ) -> torch.Tensor:
    O, ptrs, ints = _operands(x, codebooks)
    fn = build.bind(_NAME, "vq_gemm_launch", 3, 4, variant)
    with torch.cuda.device(O.device):
        build.check(fn(*ptrs, *ints, build.stream_of(O)), _NAME)
    if not variant:
        vq_gemm.launches += 1
    return O


def run_variant(x: torch.Tensor, codebooks: torch.Tensor, variant: str
                ) -> torch.Tensor:
    """Launch a timing-only variant of the kernel (``build.VARIANTS``) on
    CUDA tensors; it counts no launch. Returns O (C, M*V, 256): wrong by
    design for ``no_store`` and ``no_load``."""
    return _launch(x, codebooks, build.variant_index(_NAME, variant))


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
    if use_kernel and x.is_cuda:
        O = _launch(x, codebooks)
    elif use_kernel and x.device.type != "cpu":
        raise ValueError(f"{_NAME}: no kernel for device {x.device}")
    else:
        O = vq_gemm_ref(x.reshape(M * V, d), codebooks)
    return O.reshape(C, M, V, k)


vq_gemm.launches = 0
