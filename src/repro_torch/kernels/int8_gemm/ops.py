"""Wrapper of the INT8 GEMM kernel (``csrc/int8_gemm.cu``) and its plan
backend ``int8_cuda``: the INT8 prefill path of a dense weight under
``PlanPolicy(int8_prefill=True, impl="cuda")`` (the paper's INT8 mode of
the reconfigurable PE array; in the VQ model, the ``lm_head``).

``int8_matmul_kernel`` quantizes x per row and w per column with torch
(``core.ops.quantize_int8``, as the reference wrapper does in jnp) and
calls ``int8_gemm``, the kernel's wrapper. CPU tensors take the plain
version (``ref.py``); CUDA tensors launch the kernel or the wrapper
raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import plan as plan_mod
from repro_torch.core.ops import quantize_int8
from repro_torch.kernels import build
from repro_torch.kernels.int8_gemm.ref import int8_gemm_ref

_NAME = "int8_gemm"
K_ALIGN, N_ALIGN = 16, 16  # TMA takes rows of x and w 16-byte aligned
TOKEN_TILES = (32, 64, 128, 256)   # tokens per CTA: wgmma's N
COLS_PER_CTA = 128                 # weight columns per CTA


def launch_shape(M: int, N: int) -> Tuple[int, int, int]:
    """(tokens per CTA, CTAs along N, CTAs along M) of a launch: the
    smallest token tile that holds M (tiles of 256 above), so each weight
    tile is read once for all of a prefill bucket's tokens."""
    T = next((t for t in TOKEN_TILES if M <= t), TOKEN_TILES[-1])
    return T, -(-N // COLS_PER_CTA), -(-M // T)


def _launch(xq, wq, xs, ws) -> torch.Tensor:
    M, K = xq.shape
    N = wq.shape[1]
    dev = xq.device
    ok = (xq.dtype == torch.int8 and wq.dtype == torch.int8
          and wq.shape[0] == K and K % K_ALIGN == 0 and N % N_ALIGN == 0
          and xs.dtype == torch.float32 and tuple(xs.shape) == (M, 1)
          and ws.dtype == torch.float32 and tuple(ws.shape) == (1, N)
          and all(t.device == dev and t.is_contiguous()
                  and t.data_ptr() % 16 == 0 for t in (xq, wq, xs, ws)))
    if not ok:
        raise ValueError(
            f"{_NAME}: the kernel takes contiguous, 16-byte aligned int8 xq "
            f"(M, K) and wq (K, N) with K % {K_ALIGN} == 0 and N % {N_ALIGN} "
            f"== 0, fp32 xs (M, 1) and ws (1, N), all on one device; got xq "
            f"{xq.dtype} {tuple(xq.shape)} on {dev}, wq {wq.dtype} "
            f"{tuple(wq.shape)} on {wq.device}, xs {xs.dtype} "
            f"{tuple(xs.shape)}, ws {ws.dtype} {tuple(ws.shape)}")
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    T = launch_shape(M, N)[0]
    fn = build.bind(_NAME, "int8_gemm_launch", 5, 4)
    with torch.cuda.device(dev):
        err = fn(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                 y.data_ptr(), M, N, K, T, build.stream_of(xq))
    build.check(err, _NAME)
    int8_gemm.launches += 1
    return y


def pad_to_tiles(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
                 ws: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The operands zero-padded to the kernel's alignment, as the
    reference's wrapper pads them to its tiles: K to ``K_ALIGN`` (zeros
    add nothing to the integer sums) and N to ``N_ALIGN`` (the padded
    columns come out 0, and the caller slices them off; sLSTM's gates
    ``wi``/``wf`` have N = 4)."""
    K, N = xq.shape[1], wq.shape[1]
    pk, pn = (-K) % K_ALIGN, (-N) % N_ALIGN
    if pk:
        xq, wq = F.pad(xq, (0, pk)), F.pad(wq, (0, 0, 0, pk))
    if pn:
        wq, ws = F.pad(wq, (0, pn)), F.pad(ws, (0, pn))
    return xq, wq, xs, ws


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
              ws: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """y = float(xq @ wq) * xs * ws: int8 xq (M, K) and wq (K, N), fp32
    xs (M, 1) and ws (1, N) -> fp32 (M, N). The kernel takes the
    operands ``pad_to_tiles`` pads and its result is sliced back to N.
    ``use_kernel=False`` runs the plain version on any device."""
    if use_kernel and xq.is_cuda:
        return _launch(*(t.contiguous() for t in pad_to_tiles(
            xq, wq, xs, ws)))[:, :wq.shape[1]]
    if use_kernel and xq.device.type != "cpu":
        raise ValueError(f"{_NAME}: no kernel for device {xq.device}")
    return int8_gemm_ref(xq, wq, xs, ws)


int8_gemm.launches = 0


def int8_matmul_kernel(x: torch.Tensor, w: torch.Tensor, *,
                       out_dtype: Optional[torch.dtype] = None,
                       use_kernel: bool = True) -> torch.Tensor:
    """INT8 prefill matmul: quantize x (..., K) per row and w (K, N) per
    column, then ``int8_gemm``; returns (..., N) in ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    xq, xs = quantize_int8(x.reshape(-1, K), axis=-1)
    wq, ws = quantize_int8(w, axis=0)
    y = int8_gemm(xq, wq, xs, ws, use_kernel=use_kernel)
    return y.reshape(*lead, w.shape[-1]).to(out_dtype)


def _plan_int8_cuda(spec: plan_mod.LinearSpec,
                    policy: plan_mod.PlanPolicy) -> plan_mod.MatmulPlan:
    out_dt = getattr(torch, spec.out_dtype)

    def run(x, w):
        return int8_matmul_kernel(x, w, out_dtype=out_dt)

    cost = plan_mod.PlanCost(macs=spec.M * spec.K * spec.N, lookup_adds=0,
                             weight_bytes=spec.K * spec.N)
    return plan_mod.MatmulPlan("int8_cuda", spec, policy, (), cost, run)


plan_mod.register_backend(
    "int8_cuda", lambda s, p: s.kind == "int8" and p.impl == "cuda",
    _plan_int8_cuda)
