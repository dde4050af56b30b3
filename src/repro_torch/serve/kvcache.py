"""KV-cache utilities for serving (``repro/serve/kvcache.py``, the
contiguous full-attention subset): quantize the fp cache that prefill
returns into the engine's compressed layout (``quantize_prefill_cache_int8``
for kv_bits=8 and, with ``int4``, the packed int4 cache that
``Model.init_cache(kv_int4=True)`` lays out, ``encode_prefill_cache`` for
the KV-VQ kv_bits 4/2), then
pad it to a fixed-capacity decode cache. Positions between the true
prompt length and the bucket ride along unread: decode overwrites slot
``len`` before attention unmasks it (``pos < len``). Leaves outside the
attention nodes pass through: recurrent state, and the static cross
memories (Whisper's ``cross_k``/``cross_v``/``cross_len``, Vision's
``xk``/``xv``/``xlen``), which slot insertion writes at a slot's leading
rows; ``cache_bytes`` counts every
leaf.

An MLA config's cache nodes hold a latent ({"latent", "k_rope",
"len"}, under KV-VQ also "latent_s"; time axis -2): padded like the
attention nodes, and KV-VQ-encoded against the latent codebook.

A sliding-window config's decode cache is a ring of ``min(capacity,
window)`` positions (position p at slot ``p % ring``): ``_to_ring`` and
``_to_ring_dynamic`` reorder the last ring positions of a prefill cache
into ring order, the latter with the true length inside a longer
buffer, its ring slots past ``min(true_len, ring)`` zeroed, as the
reference does."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from repro_torch.core.vq import KVQuantConfig, kv_encode
from repro_torch.models.common import _quantize_kv


def _pad_time(x: torch.Tensor, axis: int, capacity: int) -> torch.Tensor:
    S = x.shape[axis]
    if S == capacity:
        return x
    if S > capacity:
        raise ValueError(f"prefill length {S} exceeds capacity {capacity}")
    shape = list(x.shape)
    shape[axis] = capacity
    out = x.new_zeros(shape)
    out.narrow(axis, 0, S).copy_(x)
    return out


def _to_ring(x: torch.Tensor, axis: int, ring: int) -> torch.Tensor:
    """The last ``ring`` positions of a full-length cache in ring order
    (slot = position % ring); a shorter cache is padded to ``ring``."""
    S = x.shape[axis]
    if S <= ring:
        return _pad_time(x, axis, ring)
    s = torch.arange(ring, device=x.device)
    pos = S - ring + torch.remainder(s - (S - ring), ring)
    return x.index_select(axis, pos)


def _to_ring_dynamic(x: torch.Tensor, axis: int, ring: int,
                     true_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """``_to_ring`` of the first ``true_len`` positions of ``x`` (an int,
    or a one-element device tensor: no host sync). Ring slots past
    ``min(true_len, ring)`` hold no position and are zeroed, as the
    reference's (``true_len == 0``: all zeros; ``true_len == ring``: the
    first ``ring`` positions in order)."""
    S = x.shape[axis]
    s = torch.arange(ring, device=x.device)
    if isinstance(true_len, torch.Tensor):
        tl = true_len.reshape(()).long()
        pos = torch.where(tl <= ring, s,
                          tl - ring + torch.remainder(s - tl, ring))
        valid = s < tl.clamp(max=ring)
    else:
        pos = (s if true_len <= ring
               else true_len - ring + torch.remainder(s - true_len, ring))
        valid = s < min(true_len, ring)
    out = x.index_select(axis, pos.clamp(0, S - 1))
    shape = [1] * out.dim()
    shape[axis] = ring
    return torch.where(valid.reshape(shape), out, torch.zeros_like(out))


def pad_prefill_cache(cache: Any, capacity: int, *, window: int = 0,
                      true_len: Optional[int] = None) -> Any:
    """Pad every attention cache node ({"k", "v", "len"}, time axis -3;
    its ``k_s``/``v_s`` scale leaves, time axis -2) to ``capacity``, or
    with ``window > 0`` convert it to a ring of ``min(capacity,
    window)`` positions (``_to_ring``; ``_to_ring_dynamic`` of the first
    ``true_len`` positions when given); an MLA node's leaves (time axis
    -2) are padded to ``min(capacity, window)``, never ring-converted,
    as the reference's; ``true_len`` overwrites the ``len`` leaves (the
    prompt's real length inside its padded bucket). Any other leaf
    (recurrent state beside the rings, the cross memories) passes through
    unchanged."""
    eff = min(capacity, window) if window else capacity

    def fix_time(x, axis):
        if not window:
            return _pad_time(x, axis, eff)
        if true_len is None:
            return _to_ring(x, axis, eff)
        return _to_ring_dynamic(x, axis, eff, true_len)

    def walk(node):
        if isinstance(node, dict):
            if "k" in node and "v" in node and "len" in node:
                out = dict(node)
                for n in ("k", "v"):
                    out[n] = fix_time(node[n], node[n].dim() - 3)
                for n in ("k_s", "v_s"):
                    if n in node:
                        out[n] = fix_time(node[n], node[n].dim() - 2)
                if true_len is not None:
                    out["len"] = torch.full_like(node["len"], true_len)
                return out
            if "latent" in node and "k_rope" in node:
                out = dict(node)
                for n in ("latent", "k_rope", "latent_s"):
                    if n in node:
                        out[n] = _pad_time(node[n], node[n].dim() - 2, eff)
                if true_len is not None and "len" in node:
                    out["len"] = torch.full_like(node["len"], true_len)
                return out
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache)


def quantize_prefill_cache_int8(cache: Any, *, int4: bool = False) -> Any:
    """Quantize every fp attention node of a prefill cache into the int8
    ``k``/``v`` + bf16 ``k_s``/``v_s`` layout (kv_bits=8), or with
    ``int4`` the int4 one (values in [-7, 7] packed two a byte, (..., hd
    / 2) int8), by the rule decode appends use. Prefill runs in fp; the
    engine calls this before slot insertion, which would otherwise
    truncate rather than quantize."""

    def walk(node):
        if isinstance(node, dict):
            if ("k" in node and "v" in node and "len" in node
                    and node["k"].is_floating_point()):
                kq, ks = _quantize_kv(node["k"], int4)
                vq, vs = _quantize_kv(node["v"], int4)
                return {"k": kq, "v": vq, "k_s": ks, "v_s": vs,
                        "len": node["len"]}
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(cache)


def encode_prefill_cache(cache: Any, codebooks: Any,
                         kvq: KVQuantConfig) -> Any:
    """Encode an fp prefill cache into the KV-VQ layout: every attention
    node with codebooks becomes uint8 ``k``/``v`` indices and bf16
    ``k_s``/``v_s`` scales, every MLA node uint8 ``latent`` indices and a
    bf16 ``latent_s`` (L, B, S, 1) scale, layer by layer against its own
    codebooks.

    Args:
      cache: prefill cache tree ({"body": {"k": (L, B, S, Hk, hd), ...}}
        or MLA {"body": {"latent": (L, B, S, r), ...}, "pre": ...}).
      codebooks: ``core.quantize.kv_codebook_tree(params)`` — {"body":
        {"k": (L, Hk, R, 256, vd), "v": ...}} or {"body": {"lat": (L, 1,
        R, 256, vd)}, "pre": ...}.
      kvq: the KVQuantConfig (supplies the scale variant).

    Nodes already uint8, and nodes without codebooks, pass through.
    """

    def enc(x, cbs):
        pairs = [kv_encode(x[i], cbs[i], kvq.variant)
                 for i in range(x.shape[0])]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]).to(torch.bfloat16))

    def walk(node, cbs):
        if isinstance(node, dict):
            if "k" in node and "v" in node and "len" in node:
                if cbs is None or node["k"].dtype == torch.uint8:
                    return node
                k_idx, k_s = enc(node["k"], cbs["k"])
                v_idx, v_s = enc(node["v"], cbs["v"])
                return {"k": k_idx, "v": v_idx, "k_s": k_s, "v_s": v_s,
                        "len": node["len"]}
            if "latent" in node and "k_rope" in node:
                if cbs is None or node["latent"].dtype == torch.uint8:
                    return node
                idx, sc = enc(node["latent"][..., None, :], cbs["lat"])
                out = dict(node)
                out["latent"], out["latent_s"] = idx[..., 0, :], sc
                return out
            return {k: walk(v, cbs.get(k) if isinstance(cbs, dict) else None)
                    for k, v in node.items()}
        return node

    return walk(cache, codebooks)


def cache_bytes(cache: Any) -> int:
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return 0
