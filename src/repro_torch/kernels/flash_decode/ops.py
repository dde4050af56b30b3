"""Wrappers of the flash-decode kernels: ``flash_decode``
(``csrc/flash_decode.cu``), decode attention over the contiguous fp KV
cache (``models/common.attention_fwd``, one new token, no window), and
``flash_decode_kvq`` (``csrc/flash_decode_kvq.cu``), decode attention
straight over a vector-quantized cache — uint8 codebook indices, per-
(token, head) scales and the params-resident codebooks — with its two
plan backends for ``kind="kvq_attn"`` sites:

  "kvq_dequant_torch" : the dequantize oracle (``flash_decode_kvq_ref``)
                        under impl="torch";
  "kvq_flash_cuda"    : the kernel under impl="cuda".

CPU tensors take the plain versions (``ref.py``); CUDA tensors launch the
kernel or the wrapper raises. The paged entries wait for a later slice
(ROADMAP A4).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import (flash_decode_kvq_ref,
                                                  flash_decode_ref)

_NAME = "flash_decode"
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8
FD_CHUNK = 64       # positions per CTA of the split-S kernel


def fd_splits(S: int) -> int:
    """CTAs per (row, kv head): one per ``FD_CHUNK`` positions of the
    host-known S."""
    return -(-S // FD_CHUNK)


def _launch(q, k, v, lengths) -> torch.Tensor:
    B, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    dev = q.device
    ok = (q.dtype in (torch.float32, torch.bfloat16)
          and k.dtype == q.dtype and v.dtype == q.dtype
          and hd in HEAD_DIMS and tuple(k.shape) == (B, S, Hk, hd)
          and v.shape == k.shape and H % Hk == 0 and H // Hk <= MAX_GROUP
          and lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
          and lengths.device == dev and lengths.is_contiguous()
          and all(t.device == dev and t.is_contiguous()
                  and t.data_ptr() % 16 == 0 for t in (q, k, v)))
    if not ok:
        raise ValueError(
            f"{_NAME}: the kernel takes q (B, H, hd), k/v (B, S, Hk, hd) of "
            f"one dtype (float32 or bfloat16), contiguous and 16-byte "
            f"aligned, hd in {HEAD_DIMS}, at most {MAX_GROUP} query heads per "
            f"kv head, int32 (B,) lengths, all on one device; got q "
            f"{q.dtype} {tuple(q.shape)} on {dev}, k {k.dtype} "
            f"{tuple(k.shape)} on {k.device}, lengths {lengths.dtype} "
            f"{tuple(lengths.shape)} on {lengths.device}")
    o = torch.empty_like(q)
    ws = torch.empty(B * H * fd_splits(S) * (hd + 2), dtype=torch.float32,
                     device=dev)
    fn = build.bind(_NAME, "flash_decode_launch", 6, 7)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 o.data_ptr(), ws.data_ptr(), B, S, H, Hk, hd, FD_CHUNK,
                 int(q.dtype == torch.bfloat16), build.stream_of(q))
    build.check(err, _NAME)
    flash_decode.launches += 1
    return o


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *,
                 use_kernel: bool = True) -> torch.Tensor:
    """q (B, H, hd) or (B, 1, H, hd), k/v (B, S, Hk, hd), lengths (B,)
    counting the token just written -> attention output shaped like q.
    ``use_kernel=False`` runs the plain version on any device."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    if use_kernel and q.is_cuda:
        o = _launch(q.contiguous(), k, v, lengths)
    elif use_kernel and q.device.type != "cpu":
        raise ValueError(f"{_NAME}: no kernel for device {q.device}")
    else:
        o = flash_decode_ref(q, k, v, lengths)
    return o[:, None] if squeeze else o


flash_decode.launches = 0


# ---------------------------------------------------------------------------
# KV-VQ decode attention
# ---------------------------------------------------------------------------

_KVQ = "flash_decode_kvq"
KVQ_BLOCK_S = 512   # the reference wrapper's S-block (its padding rule)
KVQ_VEC_D = (2, 4, 8)
KVQ_MAX_R = 2
KVQ_CHUNK = 256     # positions per CTA of the split-S kernel


def kvq_operands(q: torch.Tensor, k_s: torch.Tensor, v_s: torch.Tensor,
                 cb_k: torch.Tensor, cb_v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """The query / K-codebook dot table ``qd = (q . cb_k) / sqrt(hd)`` as
    fp32 (B, Hk, g, R*G, 256), built as the reference wrapper builds it in
    plain jnp, and fp32 copies of the scales and the V codebooks: the
    formulation the CPU tests hold the kernel's arithmetic to (the kernel
    builds each CTA's slice of the table itself)."""
    B, H, hd = q.shape
    Hk, R, E, vd = cb_k.shape
    G, g = hd // vd, H // Hk
    qg = q.reshape(B, Hk, g, G, vd).float()
    qd = torch.einsum("bkgcd,kred->bkgrce", qg, cb_k.float())
    qd = (qd / math.sqrt(hd)).reshape(B, Hk, g, R * G, E).contiguous()
    return (qd, k_s.float().contiguous(), v_s.float().contiguous(),
            cb_v.float().contiguous())


def kvq_padded_len(S: int) -> int:
    """The cache length the reference kernel walks: S rounded up to its
    S-block ``min(512, S)``, the padding holding zero indices and zero
    scales. It shows only where a row attends past its length (an empty
    row averages V over the padded cache)."""
    bs = min(KVQ_BLOCK_S, S)
    return -(-S // bs) * bs


def kvq_splits(S: int, chunk: int) -> int:
    """CTAs per (row, kv head) over the padded cache: one per ``chunk``
    positions, from the host-known S."""
    return -(-kvq_padded_len(S) // chunk)


def _launch_kvq(q, k_idx, v_idx, k_s, v_s, lengths, cb_k, cb_v
                ) -> torch.Tensor:
    B, H, hd = q.shape
    S, Hk, RG = k_idx.shape[1], k_idx.shape[2], k_idx.shape[3]
    Hk_cb, R, E, vd = cb_k.shape
    dev = q.device
    ok = (q.dtype in (torch.float32, torch.bfloat16) and hd in HEAD_DIMS
          and H % Hk == 0 and H // Hk <= MAX_GROUP and Hk_cb == Hk
          and E == 256 and vd in KVQ_VEC_D and 1 <= R <= KVQ_MAX_R
          and hd % vd == 0 and RG == R * (hd // vd)
          and k_idx.dtype == torch.uint8 and v_idx.dtype == torch.uint8
          and v_idx.shape == k_idx.shape and tuple(k_idx.shape[:2]) == (B, S)
          and tuple(k_s.shape) == (B, S, Hk) and v_s.shape == k_s.shape
          and k_s.dtype in (torch.float32, torch.bfloat16)
          and v_s.dtype == k_s.dtype
          and cb_v.shape == cb_k.shape
          and cb_k.dtype == cb_v.dtype == torch.float32
          and lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
          and all(t.device == dev and t.is_contiguous()
                  for t in (k_idx, v_idx, k_s, v_s, cb_k, cb_v, lengths)))
    if not ok:
        raise ValueError(
            f"{_KVQ}: the kernel takes q (B, H, hd) float32 or bfloat16 with "
            f"hd in {HEAD_DIMS} and at most {MAX_GROUP} query heads per kv "
            f"head, contiguous uint8 k/v indices (B, S, Hk, R*hd/vd), "
            f"contiguous bfloat16 or float32 k/v scales (B, S, Hk), "
            f"contiguous float32 codebooks (Hk, R, 256, vd) with vd in "
            f"{KVQ_VEC_D} and R <= {KVQ_MAX_R}, int32 (B,) lengths, all on "
            f"one device; got q {q.dtype} {tuple(q.shape)} on {dev}, "
            f"indices {k_idx.dtype} {tuple(k_idx.shape)} on {k_idx.device}, "
            f"scales {k_s.dtype} {tuple(k_s.shape)}, codebooks {cb_k.dtype} "
            f"{tuple(cb_k.shape)}, lengths {lengths.dtype} "
            f"{tuple(lengths.shape)}")
    chunk = KVQ_CHUNK
    o = torch.empty_like(q)
    ws = torch.empty(B * H * kvq_splits(S, chunk) * (hd + 2),
                     dtype=torch.float32, device=dev)
    fn = build.bind(_KVQ, "flash_decode_kvq_launch", 10, 11)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k_idx.data_ptr(), v_idx.data_ptr(),
                 k_s.data_ptr(), v_s.data_ptr(), cb_k.data_ptr(),
                 cb_v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
                 ws.data_ptr(), B, S, kvq_padded_len(S), H, Hk, hd, R, vd,
                 chunk, int(q.dtype == torch.bfloat16),
                 int(k_s.dtype == torch.bfloat16), build.stream_of(q))
    build.check(err, _KVQ)
    flash_decode_kvq.launches += 1
    return o


def flash_decode_kvq(q: torch.Tensor, k_idx: torch.Tensor,
                     v_idx: torch.Tensor, k_s: torch.Tensor,
                     v_s: torch.Tensor, lengths: torch.Tensor,
                     cb_k: torch.Tensor, cb_v: torch.Tensor, *,
                     use_kernel: bool = True) -> torch.Tensor:
    """Decode attention over a KV-VQ cache: q (B, H, hd) or (B, 1, H,
    hd), k_idx/v_idx (B, S, Hk, R*G) uint8, k_s/v_s (B, S, Hk), lengths
    (B,) counting the token just written, cb_k/cb_v (Hk, R, 256, vd) ->
    attention output shaped like q. ``use_kernel=False`` runs the plain
    version (``flash_decode_kvq_ref``) on any device."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    if use_kernel and q.is_cuda:
        o = _launch_kvq(q.contiguous(), k_idx, v_idx, k_s, v_s, lengths,
                        cb_k, cb_v)
    elif use_kernel and q.device.type != "cpu":
        raise ValueError(f"{_KVQ}: no kernel for device {q.device}")
    else:
        o = flash_decode_kvq_ref(q, k_idx, v_idx, k_s, v_s, lengths, cb_k,
                                 cb_v)
    return o[:, None] if squeeze else o


flash_decode_kvq.launches = 0


def _kvq_idx_bytes(spec: plan_mod.LinearSpec) -> int:
    """Per-step compressed cache traffic: two uint8 index planes of (B, S,
    Hk, idx_width) and two bf16 scale planes."""
    return (2 * spec.M * spec.K * spec.C * spec.V
            + 4 * spec.M * spec.K * spec.C)


def _kvq_cost(spec: plan_mod.LinearSpec, use_kernel: bool
              ) -> plan_mod.PlanCost:
    """The reference's cost terms (``kvq_dequant_jnp`` and
    ``kvq_flash_pallas``), so both packages price a site alike."""
    if not use_kernel:
        # dequantize-then-attend: QK+PV macs over the rebuilt cache, plus
        # a round trip of the two fp32 rebuilt planes
        return plan_mod.PlanCost(
            macs=2 * spec.M * spec.K * spec.N,
            lookup_adds=2 * spec.M * spec.K * spec.C * spec.V,
            weight_bytes=_kvq_idx_bytes(spec),
            intermediate_bytes=8 * spec.M * spec.K * spec.C * spec.d,
            launches=3)
    # the S-independent query/K-codebook table (N * entries macs per row)
    # and per-token index gathers; the only intermediate is the qd table
    H = spec.N // spec.d
    return plan_mod.PlanCost(
        macs=spec.M * spec.N * spec.k,
        lookup_adds=spec.M * spec.K * (H + spec.C) * spec.V,
        weight_bytes=_kvq_idx_bytes(spec),
        intermediate_bytes=4 * spec.M * H * spec.V * spec.k,
        launches=1)


def _plan_kvq(backend: str, use_kernel: bool):
    def planner_fn(spec: plan_mod.LinearSpec,
                   policy: plan_mod.PlanPolicy) -> plan_mod.MatmulPlan:
        def run(operands, _leaf):
            return flash_decode_kvq(*operands, use_kernel=use_kernel)

        return plan_mod.MatmulPlan(backend, spec, policy, (),
                                   _kvq_cost(spec, use_kernel), run)

    return planner_fn


plan_mod.register_backend(
    "kvq_dequant_torch",
    lambda s, p: s.kind == "kvq_attn" and p.impl == "torch",
    _plan_kvq("kvq_dequant_torch", use_kernel=False))
plan_mod.register_backend(
    "kvq_flash_cuda",
    lambda s, p: s.kind == "kvq_attn" and p.impl == "cuda",
    _plan_kvq("kvq_flash_cuda", use_kernel=True))
