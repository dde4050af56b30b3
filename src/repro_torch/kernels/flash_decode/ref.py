"""Plain PyTorch versions of the flash-decode kernels (``repro``'s
``flash_decode_ref`` and ``flash_decode_kvq_ref``): masked softmax over
the whole fp cache; for the KV-VQ cache, the dequantize oracle —
reconstruct the fp cache through ``core.vq.kv_decode``, then attend. The
paged versions gather the slot-contiguous view through the block table
(sentinel ids clamped to the last block, the reference's ``mode="clip"``)
and run the contiguous ones, as the reference's paged wrappers do."""
from __future__ import annotations

import math

import torch

from repro_torch.core.vq import kv_decode
from repro_torch.models.common import paged_view


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd), k/v (B, S, Hk, hd), lengths (B,) -> (B, H, hd) in
    q's dtype; positions >= lengths[b] are masked with -1e30."""
    B, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    qg = q.reshape(B, Hk, g, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(hd)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def flash_decode_kvq_ref(q: torch.Tensor, k_idx: torch.Tensor,
                         v_idx: torch.Tensor, k_s: torch.Tensor,
                         v_s: torch.Tensor, lengths: torch.Tensor,
                         cb_k: torch.Tensor, cb_v: torch.Tensor
                         ) -> torch.Tensor:
    """q (B, H, hd), k_idx/v_idx (B, S, Hk, R*G) uint8, k_s/v_s (B, S,
    Hk), lengths (B,), cb_k/cb_v (Hk, R, 256, vd) -> (B, H, hd) in q's
    dtype."""
    k = kv_decode(k_idx, k_s, cb_k)
    v = kv_decode(v_idx, v_s, cb_v)
    return flash_decode_ref(q, k, v, lengths)


def flash_decode_paged_ref(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd), k/v arenas (NB, bs, Hk, hd), block_table (B, W)
    (NB = no block), lengths (B,) -> (B, H, hd)."""
    return flash_decode_ref(q, paged_view(k_arena, block_table),
                            paged_view(v_arena, block_table), lengths)


def flash_decode_kvq_paged_ref(q: torch.Tensor, k_arena: torch.Tensor,
                               v_arena: torch.Tensor, ks_arena: torch.Tensor,
                               vs_arena: torch.Tensor,
                               block_table: torch.Tensor,
                               lengths: torch.Tensor, cb_k: torch.Tensor,
                               cb_v: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd), index arenas (NB, bs, Hk, R*G) uint8, scale arenas
    (NB, bs, Hk), block_table (B, W), lengths (B,), cb_k/cb_v (Hk, R,
    256, vd) -> (B, H, hd)."""
    view = lambda a: paged_view(a, block_table)
    return flash_decode_kvq_ref(q, view(k_arena), view(v_arena),
                                view(ks_arena), view(vs_arena), lengths,
                                cb_k, cb_v)
