"""Plain PyTorch version of the flash-decode kernel (``repro``'s
``flash_decode_ref``): masked softmax over the whole fp cache."""
from __future__ import annotations

import math

import torch


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
