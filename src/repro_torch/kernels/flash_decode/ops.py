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

Each has a paged entry with the reference's signature,
``flash_decode_paged`` and ``flash_decode_kvq_paged``: the cache is a
block arena (NB, bs, ...) and a (B, W) int32 block table (``serve/
paging.py``; NB marks no block). The kernels read the table themselves
(the same source compiled with the table's addressing: position p of row
b is arena row ``min(table[b, p / bs], NB - 1) * bs + p % bs``), with
the contiguous kernel's arithmetic, so a paged launch equals the
contiguous kernel on the gathered view bit for bit, and no view is
gathered on the card. A paged KV-VQ site carries the block table among
its plan operands, after the scale arenas.

CPU tensors take the plain versions (``ref.py``); CUDA tensors launch the
kernel or the wrapper raises. Each entry counts its own launches.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import (flash_decode_kvq_paged_ref,
                                                  flash_decode_kvq_ref,
                                                  flash_decode_paged_ref,
                                                  flash_decode_ref)

_NAME = "flash_decode"
_PAGED = "flash_decode_paged"
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


def _check_table(name, block_table, B, dev) -> int:
    """W of a (B, W) int32 block table, contiguous on ``dev``; raises
    otherwise."""
    if not (block_table.dtype == torch.int32 and block_table.dim() == 2
            and block_table.shape[0] == B and block_table.shape[1] >= 1
            and block_table.device == dev and block_table.is_contiguous()):
        raise ValueError(
            f"{name}: the block table must be a contiguous int32 (B, W) "
            f"tensor with B = {B} on {dev}; got {block_table.dtype} "
            f"{tuple(block_table.shape)} on {block_table.device}")
    return block_table.shape[1]


def _launch_paged(q, k, v, block_table, lengths) -> torch.Tensor:
    B, H, hd = q.shape
    dev = q.device
    W = _check_table(_PAGED, block_table, B, dev)
    if k.dim() != 4:
        raise ValueError(f"{_PAGED}: the arenas are (NB, bs, Hk, hd); got k "
                         f"{tuple(k.shape)}")
    NB, bs, Hk = k.shape[0], k.shape[1], k.shape[2]
    ok = (q.dtype in (torch.float32, torch.bfloat16)
          and k.dtype == q.dtype and v.dtype == q.dtype
          and hd in HEAD_DIMS and k.shape[3] == hd and v.shape == k.shape
          and NB >= 1 and bs >= 1 and H % Hk == 0 and H // Hk <= MAX_GROUP
          and lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
          and lengths.device == dev and lengths.is_contiguous()
          and all(t.device == dev and t.is_contiguous()
                  and t.data_ptr() % 16 == 0 for t in (q, k, v)))
    if not ok:
        raise ValueError(
            f"{_PAGED}: the kernel takes q (B, H, hd), k/v arenas (NB, bs, "
            f"Hk, hd) of q's dtype (float32 or bfloat16), contiguous and "
            f"16-byte aligned, hd in {HEAD_DIMS}, at most {MAX_GROUP} query "
            f"heads per kv head, int32 (B,) lengths, all on one device; got "
            f"q {q.dtype} {tuple(q.shape)} on {dev}, k {k.dtype} "
            f"{tuple(k.shape)} on {k.device}, v {tuple(v.shape)}, lengths "
            f"{lengths.dtype} {tuple(lengths.shape)} on {lengths.device}")
    o = torch.empty_like(q)
    ws = torch.empty(B * H * fd_splits(W * bs) * (hd + 2),
                     dtype=torch.float32, device=dev)
    fn = build.bind(_PAGED, "flash_decode_paged_launch", 7, 9)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 block_table.data_ptr(), lengths.data_ptr(), o.data_ptr(),
                 ws.data_ptr(), B, NB, bs, W, H, Hk, hd, FD_CHUNK,
                 int(q.dtype == torch.bfloat16), build.stream_of(q))
    build.check(err, _PAGED)
    flash_decode_paged.launches += 1
    return o


def flash_decode_paged(q: torch.Tensor, k_arena: torch.Tensor,
                       v_arena: torch.Tensor, block_table: torch.Tensor,
                       lengths: torch.Tensor, *,
                       use_kernel: bool = True) -> torch.Tensor:
    """Flash decode over a paged fp cache: q (B, H, hd) or (B, 1, H, hd),
    k/v arenas (NB, bs, Hk, hd), block_table (B, W) int32 (NB = no
    block), lengths (B,) -> attention output shaped like q, equal to
    ``flash_decode`` over the gathered (B, W * bs) view.
    ``use_kernel=False`` runs the plain version on any device."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    if use_kernel and q.is_cuda:
        o = _launch_paged(q.contiguous(), k_arena, v_arena, block_table,
                          lengths)
    elif use_kernel and q.device.type != "cpu":
        raise ValueError(f"{_PAGED}: no kernel for device {q.device}")
    else:
        o = flash_decode_paged_ref(q, k_arena, v_arena, block_table, lengths)
    return o[:, None] if squeeze else o


flash_decode_paged.launches = 0


# ---------------------------------------------------------------------------
# KV-VQ decode attention
# ---------------------------------------------------------------------------

_KVQ = "flash_decode_kvq"
_KVQ_PAGED = "flash_decode_kvq_paged"
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


def _launch_kvq(q, k_idx, v_idx, k_s, v_s, lengths, cb_k, cb_v,
                block_table=None) -> torch.Tensor:
    """Both KV-VQ entries: with ``block_table`` the index and scale
    leaves are arenas (NB, bs, ...) read through it, else the contiguous
    cache (B, S, ...)."""
    B, H, hd = q.shape
    dev = q.device
    paged = block_table is not None
    name = _KVQ_PAGED if paged else _KVQ
    if k_idx.dim() != 4:
        raise ValueError(f"{name}: the index leaves are 4-d; got "
                         f"{tuple(k_idx.shape)}")
    lead, Hk, RG = tuple(k_idx.shape[:2]), k_idx.shape[2], k_idx.shape[3]
    if paged:
        W = _check_table(name, block_table, B, dev)
        S = W * lead[1]
    else:
        S = lead[1]
    Hk_cb, R, E, vd = cb_k.shape
    ok = (q.dtype in (torch.float32, torch.bfloat16) and hd in HEAD_DIMS
          and H % Hk == 0 and H // Hk <= MAX_GROUP and Hk_cb == Hk
          and E == 256 and vd in KVQ_VEC_D and 1 <= R <= KVQ_MAX_R
          and hd % vd == 0 and RG == R * (hd // vd)
          and k_idx.dtype == torch.uint8 and v_idx.dtype == torch.uint8
          and v_idx.shape == k_idx.shape and min(lead) >= 1
          and (paged or lead[0] == B)
          and tuple(k_s.shape) == lead + (Hk,) and v_s.shape == k_s.shape
          and k_s.dtype in (torch.float32, torch.bfloat16)
          and v_s.dtype == k_s.dtype
          and cb_v.shape == cb_k.shape
          and cb_k.dtype == cb_v.dtype == torch.float32
          and lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
          and all(t.device == dev and t.is_contiguous()
                  for t in (k_idx, v_idx, k_s, v_s, cb_k, cb_v, lengths)))
    if not ok:
        where = "arenas (NB, bs, " if paged else "(B, S, "
        raise ValueError(
            f"{name}: the kernel takes q (B, H, hd) float32 or bfloat16 with "
            f"hd in {HEAD_DIMS} and at most {MAX_GROUP} query heads per kv "
            f"head, contiguous uint8 k/v index {where}Hk, R*hd/vd), "
            f"contiguous bfloat16 or float32 k/v scale {where}Hk), "
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
    ptrs = [q, k_idx, v_idx, k_s, v_s, cb_k, cb_v]
    ints = [kvq_padded_len(S), H, Hk, hd, R, vd, chunk,
            int(q.dtype == torch.bfloat16), int(k_s.dtype == torch.bfloat16)]
    if paged:
        fn = build.bind(name, "flash_decode_kvq_paged_launch", 11, 13)
        ptrs.append(block_table)
        ints = [B, lead[0], lead[1], W] + ints
    else:
        fn = build.bind(name, "flash_decode_kvq_launch", 10, 11)
        ints = [B, S] + ints
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in ptrs), lengths.data_ptr(),
                 o.data_ptr(), ws.data_ptr(), *ints, build.stream_of(q))
    build.check(err, name)
    (flash_decode_kvq_paged if paged else flash_decode_kvq).launches += 1
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


def flash_decode_kvq_paged(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, ks_arena: torch.Tensor,
                           vs_arena: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, cb_k: torch.Tensor,
                           cb_v: torch.Tensor, *,
                           use_kernel: bool = True) -> torch.Tensor:
    """KV-VQ decode attention over a paged cache: index arenas (NB, bs,
    Hk, R*G) uint8, scale arenas (NB, bs, Hk), block_table (B, W) int32
    (NB = no block); the rest as ``flash_decode_kvq``, whose output over
    the gathered (B, W * bs) view it equals. ``use_kernel=False`` runs the
    plain version on any device."""
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, 0]
    if use_kernel and q.is_cuda:
        o = _launch_kvq(q.contiguous(), k_arena, v_arena, ks_arena,
                        vs_arena, lengths, cb_k, cb_v, block_table)
    elif use_kernel and q.device.type != "cpu":
        raise ValueError(f"{_KVQ_PAGED}: no kernel for device {q.device}")
    else:
        o = flash_decode_kvq_paged_ref(q, k_arena, v_arena, ks_arena,
                                       vs_arena, block_table, lengths, cb_k,
                                       cb_v)
    return o[:, None] if squeeze else o


flash_decode_kvq_paged.launches = 0


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
            # a paged site's operands carry the block table (9, else 8)
            fn = flash_decode_kvq_paged if len(operands) == 9 else flash_decode_kvq
            return fn(*operands, use_kernel=use_kernel)

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
