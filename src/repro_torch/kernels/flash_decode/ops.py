"""Wrapper of the flash-decode kernel (``csrc/flash_decode.cu``): decode
attention over the contiguous fp KV cache (``models/common.attention_fwd``,
one new token, no window).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or the wrapper raises. The paged entry and the KV-VQ variant wait
for later slices (ROADMAP A8, B7).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

_NAME = "flash_decode"
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8


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
    fn = build.bind(_NAME, "flash_decode_launch", 5, 6)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 o.data_ptr(), B, S, H, Hk, hd,
                 1 if q.dtype == torch.bfloat16 else 0, build.stream_of(q))
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
