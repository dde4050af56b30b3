"""Matmul formulations (``repro/core/ops.py``).

  fp_matmul       : dense matmul (the dense ``lm_head``).
  quantize_int8   : symmetric per-slice int8 quantization.
  int8_matmul     : the INT8 prefill formulation (per-token int8
                    activations x per-channel int8 weights, exact integer
                    accumulation, fp dequant) — the plain version of the
                    ``int8_gemm`` kernel's wrapper.
  dequant_matmul  : conventional VQ — reconstruct W_hat, then matmul (the
                    plain formulation every VQ kernel is held against).
  eva_epilogue_exec : the paper's EVA formulation in plain PyTorch — the
                    VQ-GEMM O = X·B (``compute_output_codebook``), then the
                    output-codebook lookup and add-only reduction, in one
                    of four algebraically identical epilogues (below).

The four epilogues compute y[m, j] = s[j] * sum_c sum_v O[c, m, v,
I[c, v, j]]:

  direct  : one gather over the whole O (C*M*V*N gathered elements), the
            M < d decode regime;
  flat    : the same work as one 1-D gather by precomputed flat indices;
  blocked : the gather over V tiles of ``block_v`` rows, so the live
            gathered intermediate is (C, M, block_v, N);
  recon   : rebuild W_hat in (block_v*d, N) slabs and accumulate
            x_slab @ w_slab — C*V*N*d gathers, independent of M.

``select_epilogue`` picks one per shape from the reference's gather-work
and cache-footprint models (its constants are the reference's, kept so
that both packages choose alike); it is called from the ``eva_*`` plan
backends of ``core/plan.py`` only, which run under ``impl="torch"``:
the plain EVA decode matmul. On the card, ``impl="cuda"`` runs the
hand-written kernels instead (``kernels/fused_vq_matmul``,
``kernels/oc_lookup``). ``eva_matmul`` / ``vq_matmul`` are thin wrappers
over ``plan_vq(...).execute(...)`` for scripts and tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.vq import VQWeight, dequantize

EPILOGUES = ("direct", "flat", "blocked", "recon")

# Working set past which the un-blocked gather epilogues lose to the
# v-blocked one: the gathered (C, M, V, N) fp32 intermediate plus the
# (C, M, V, 2^n) O operand.
EPILOGUE_CACHE_BYTES = 96 * 1024 * 1024

# Target for the live slab of one v-block of the blocked gather ((C, M,
# bv, N + 2^n) fp32).
EPILOGUE_SLAB_BYTES = 24 * 1024 * 1024

# Target for one reconstructed (block_v*d, N) fp32 slab of recon.
RECON_SLAB_BYTES = 16 * 1024 * 1024

# Floor of the auto-sized v-blocks.
_MIN_BLOCK_V = 8


def epilogue_gather_bytes(M: int, V: int, N: int, C: int, k: int = 256) -> int:
    """Footprint of one un-blocked epilogue pass: the gathered
    intermediate (C, M, V, N) fp32 plus the O operand (C, M, V, k) fp32."""
    return 4 * C * M * V * (N + k)


def _pow2_floor(x: int) -> int:
    return 1 << (int(x).bit_length() - 1)


def auto_block_v(M: int, V: int, N: int, C: int, k: int = 256, *,
                 slab_bytes: Optional[int] = None) -> int:
    """Largest v-block whose live gathered slab (C, M, bv, N+k) fp32 fits
    the slab budget, clamped to [_MIN_BLOCK_V, V] and rounded down to a
    power of two."""
    budget = slab_bytes or EPILOGUE_SLAB_BYTES
    per_v = 4 * C * M * (N + k)
    bv = max(_MIN_BLOCK_V, budget // max(per_v, 1))
    bv = min(bv, V)
    return max(_MIN_BLOCK_V, _pow2_floor(bv))


def auto_recon_block_v(V: int, N: int, d: int) -> int:
    """v-block of the recon epilogue: the reconstructed (bv*d, N) fp32
    slab sized to RECON_SLAB_BYTES, clamped to [32, V], a power of two."""
    bv = max(32, RECON_SLAB_BYTES // max(4 * d * N, 1))
    bv = min(bv, V)
    return max(1, _pow2_floor(bv))


def select_epilogue(M: int, V: int, N: int, C: int = 2, k: int = 256,
                    d: int = 8, *, cache_bytes: Optional[int] = None
                    ) -> Tuple[str, Optional[int]]:
    """The epilogue of an (M, K=V*d) x (K, N) EVA matmul, as the
    reference picks it off a mesh (the port runs on one card, so its
    ``flat`` is chosen only on request): (epilogue, block_v or None).

      * M < d -> the gather regime: ("direct", None) while the gathered
        intermediate fits ``cache_bytes`` (EPILOGUE_CACHE_BYTES), else
        ("blocked", bv) with the slab sized to its budget;
      * M >= d -> ("recon", bv).
    """
    if M >= d:
        return "recon", auto_recon_block_v(V, N, d)
    budget = cache_bytes or EPILOGUE_CACHE_BYTES
    if epilogue_gather_bytes(M, V, N, C, k) <= budget:
        return "direct", None
    bv = auto_block_v(M, V, N, C, k)
    if bv >= V:  # one block is the direct epilogue
        return "direct", None
    return "blocked", bv


def _eva_policy_args(epilogue, block_v, impl: str
                     ) -> Tuple[str, Optional[int]]:
    """The eva_matmul keyword surface as the plan's (epilogue, block_v):
    ``block_v="auto"`` is auto-sized (None); a bare int with the default
    epilogue selects the v-blocked gather under ``impl="torch"``; None
    raises, as the reference's (its legacy spelling of "direct")."""
    if block_v is None:
        raise ValueError(
            "passing None for block_v was removed (it was the legacy "
            "spelling of the direct epilogue); pass epilogue='direct', "
            "block_v='auto' or an int")
    bv = None if block_v == "auto" else block_v
    if epilogue is None:
        if isinstance(bv, int) and not isinstance(bv, bool) \
                and impl == "torch":
            return "blocked", bv
        return "auto", bv
    return epilogue, bv


def fp_matmul(x: torch.Tensor, w: torch.Tensor, *,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense y = x @ w with fp32 accumulation, as the reference's. An fp32
    ``out_dtype`` over lower-precision operands returns the fp32
    accumulator itself, never a product rounded to x's dtype: on CUDA
    ``torch.mm(..., out_dtype=torch.float32)`` over the 2-D view of x
    (no upcast copy of w), on the CPU the product of both operands upcast
    to fp32 (exact upcasts; ``aten::mm.dtype`` has no CPU kernel), and
    on every device while autograd records the product (a training
    step: the upcast product's derivative is the plain one's). Every
    other case is ``torch.matmul`` cast to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    if out_dtype == torch.float32 and x.dtype != torch.float32:
        grad = torch.is_grad_enabled() and (x.requires_grad
                                            or w.requires_grad)
        if x.is_cuda and w.dtype == x.dtype and w.dim() == 2 and not grad:
            y = torch.mm(x.reshape(-1, x.shape[-1]), w,
                         out_dtype=torch.float32)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return torch.matmul(x.float(), w.float())
    return torch.matmul(x, w).to(out_dtype)


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-slice int8 quantization along ``axis``: returns
    (int8 q, fp32 scale with ``axis`` kept as 1). ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 (M, K) and (K, N) operands, as an
    integer-valued float64 tensor: every partial sum is bounded by
    127^2 * K < 2^53, so float64 accumulates exactly in any order (CUDA
    has no integer matmul, and an int8 ``torch.matmul`` would overflow)."""
    return torch.matmul(xq.double(), wq.double())


def int8_matmul(x: torch.Tensor, w: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """INT8 prefill path: per-token int8 activations x per-channel int8
    weights -> exact integer accumulation -> fp32 ``(acc * xs) * ws``."""
    out_dtype = out_dtype or x.dtype
    lead, K = x.shape[:-1], x.shape[-1]
    xq, xs = quantize_int8(x.reshape(-1, K), axis=-1)      # (M, K), (M, 1)
    wq, ws = quantize_int8(w, axis=0)                       # (K, N), (1, N)
    y = int8_dot(xq, wq).float() * xs * ws
    return y.reshape(*lead, w.shape[-1]).to(out_dtype)


def dequant_matmul(x: torch.Tensor, vq: VQWeight, *,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Conventional VQ baseline: materialize W_hat (K, N) fp32, then an
    fp32 matmul — the numerical oracle of the VQ kernels."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.float(), dequantize(vq)).to(out_dtype)


def compute_output_codebook(x: torch.Tensor, vq: VQWeight) -> torch.Tensor:
    """The VQ-GEMM O = X·B: x (..., K) -> O (C, M, V, 2^n) fp32, M the
    product of x's leading dims (M*K*2^n MACs, independent of N)."""
    X = x.reshape(-1, vq.V, vq.d).float()
    return torch.einsum("mvd,cdk->cmvk", X, vq.codebooks.float())


def _recon_epilogue(x: torch.Tensor, vq: VQWeight, bv: int) -> torch.Tensor:
    """v-blocked reconstruct-and-GEMM: for each V tile of ``bv`` rows,
    rebuild its (bv*d, N) fp32 slab of W_hat (C centroid gathers summed)
    and accumulate x_slab @ w_slab. Returns (M, N) fp32, scaled."""
    V, N, d = vq.V, vq.N, vq.d
    X = x.reshape(-1, V, d).float()
    M = X.shape[0]
    cb = vq.codebooks.float().transpose(-1, -2)            # (C, k, d)
    I = vq.idx.long()                                      # (C, V, N)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for lo in range(0, V, min(bv, V)):
        hi = min(lo + bv, V)
        w = cb[0][I[0, lo:hi]]                             # (b, N, d)
        for c in range(1, vq.C):
            w = w + cb[c][I[c, lo:hi]]
        w = w.transpose(1, 2).reshape((hi - lo) * d, N)
        acc = acc + X[:, lo:hi].reshape(M, (hi - lo) * d) @ w
    return acc * vq.scale.float()[None, :]


def eva_epilogue_exec(x: torch.Tensor, vq: VQWeight, *, kind: str,
                      block_v: Optional[int] = None,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Run ONE resolved EVA formulation (no selection here):

      O = X·B                                          (VQ-GEMM)
      y[m, j] = s[j] * sum_c sum_v O[c, m, v, I[c, v, j]]   (epilogue)

    ``kind`` is one of EPILOGUES and ``block_v`` the resolved v-block of
    the v-blocked kinds, both frozen in a MatmulPlan (the ``eva_*``
    backends of ``core/plan.py``). Plain PyTorch on any device; the
    "direct" kind is also B1's plain version
    (``kernels/fused_vq_matmul/ref.py``)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    V, N, C = vq.V, vq.N, vq.C
    if kind == "recon":
        y = _recon_epilogue(x, vq, block_v)
        return y.reshape(*lead, N).to(out_dtype)
    O = compute_output_codebook(x, vq)                     # (C, M, V, k)
    M, k = O.shape[1], O.shape[-1]
    I = vq.idx.long()                                      # (C, V, N)
    if kind == "flat":
        c_iota = torch.arange(C, device=I.device)[:, None, None]
        v_iota = torch.arange(V, device=I.device)[None, :, None]
        flat = ((c_iota * V + v_iota) * k + I).reshape(-1)   # (C*V*N,)
        O2 = O.transpose(0, 1).reshape(M, C * V * k)
        acc = O2[:, flat].reshape(M, C, V, N).sum(dim=(1, 2))
    elif kind == "direct":
        acc = torch.gather(O, 3, I[:, None].expand(C, M, V, N)).sum(
            dim=(0, 2))
    elif kind == "blocked":
        acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
        for lo in range(0, V, block_v):
            hi = min(lo + block_v, V)
            g = torch.gather(O[:, :, lo:hi], 3,
                             I[:, None, lo:hi].expand(C, M, hi - lo, N))
            acc = acc + g.sum(dim=(0, 2))
    else:
        raise ValueError(f"unknown epilogue kind {kind!r}")
    y = acc * vq.scale.float()[None, :]
    return y.reshape(*lead, N).to(out_dtype)


def eva_matmul(x: torch.Tensor, vq: VQWeight, *,
               epilogue: Optional[str] = None, block_v="auto",
               out_dtype: Optional[torch.dtype] = None,
               impl: str = "torch") -> torch.Tensor:
    """EVA decode matmul y = x @ W_hat through the output-codebook
    lookup, planned and run: under ``impl="torch"`` one of the plain
    epilogues (``epilogue="auto"``/None: ``select_epilogue`` per shape;
    or "direct" | "flat" | "blocked" | "recon", an int ``block_v`` pinning
    the v-block of the v-blocked kinds), under ``impl="cuda"`` the
    kernels the planner ranks (``eva_fused`` | ``eva_split``; only
    ``epilogue="auto"`` applies)."""
    from repro_torch.core import plan as plan_mod  # plan imports this module

    epi, bv = _eva_policy_args(epilogue, block_v, impl)
    policy = plan_mod.PlanPolicy(vq_mode="eva", impl=impl, epilogue=epi,
                                 block_v=bv)
    return plan_mod.plan_vq(x, vq, policy, out_dtype=out_dtype).execute(x, vq)


def vq_matmul(x: torch.Tensor, vq: VQWeight, *, mode: str = "eva",
              epilogue: Optional[str] = None, block_v="auto",
              out_dtype: Optional[torch.dtype] = None,
              impl: str = "torch") -> torch.Tensor:
    """The unified VQ matmul entry point (``Planner.plan(...).execute``):
    ``mode="eva"`` takes ``eva_matmul``'s epilogue surface; for
    ``mode="dequant"`` an int ``block_v`` is carried in the policy and no
    epilogue applies.

    Raises:
      ValueError: an unknown ``mode``."""
    from repro_torch.core import plan as plan_mod

    if mode == "eva":
        epi, bv = _eva_policy_args(epilogue, block_v, impl)
    elif mode == "dequant":
        epi = "auto"
        bv = block_v if isinstance(block_v, int) \
            and not isinstance(block_v, bool) else None
    else:
        raise ValueError(f"unknown vq matmul mode {mode!r}")
    policy = plan_mod.PlanPolicy(vq_mode=mode, impl=impl, epilogue=epi,
                                 block_v=bv)
    return plan_mod.plan_vq(x, vq, policy, out_dtype=out_dtype).execute(x, vq)


def split_grouped_outputs(y: torch.Tensor, vq: VQWeight
                          ) -> Tuple[torch.Tensor, ...]:
    """Slice a grouped-family output (y = x @ [W1|..|Wg]) into the
    members' outputs at the recorded split points (views, no copy)."""
    if not vq.splits:
        return (y,)
    return tuple(torch.split(y, list(vq.splits), dim=-1))


def vq_gemm_macs(M: int, K: int, n: int, C: int, d: int) -> int:
    """MACs of the VQ-GEMM stage O = X·B: (M*K/d) rows x 2^n cols x d
    depth, per codebook."""
    return C * M * (K // d) * (2 ** n) * d


def epilogue_adds(M: int, K: int, N: int, C: int, d: int) -> int:
    """Add-only lookup epilogue: one add per (m, v, j, c)."""
    return C * M * (K // d) * N
