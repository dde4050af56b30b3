"""Paged KV memory (``repro/serve/paging.py``): a block pool and block
tables in place of the per-slot contiguous time axis.

With 2-bit weights the KV cache, not the weights, bounds how many
requests one card serves; the contiguous cache reserves ``num_slots x
max_len`` positions up front whatever the requests use. Here:

  * ``BlockPool``     a host-side LIFO free list over ``num_blocks``
                      physical blocks. A block spans ``block_size``
                      positions of every cache leaf of every layer, so
                      one block id is valid in all arenas at once.
  * arenas + table    every attention cache leaf swaps its ``(L, B, S,
                      ...)`` time axis for a shared arena ``(L, NB + 1,
                      bs, ...)``; a ``block_table`` leaf ``(L, B, W)``
                      int32 holds each slot's physical block ids (logical
                      block j of slot b lives at ``arena[:, table[:, b,
                      j]]``; every layer's row is the same).
  * the sentinel      ``NB`` (one past the pool) marks a table entry with
                      no block. A write routed to it lands in the arenas'
                      last block, the SINK, which the pool never hands out
                      and no read returns: the reference drops such
                      writes (``mode="drop"``), which ``index_put_`` cannot,
                      and the sink keeps every write of a step on a target
                      of its own (no live row shares one with a dropped
                      write). A read of the sentinel clamps to block ``NB
                      - 1``, as the reference's ``mode="clip"`` gather
                      does; the attention mask (``pos < len``) never shows
                      it. The reference's arenas are ``arena[:, :NB]``.

Attention nodes ({"k", "v", "len"} and the int8 / KV-VQ scale leaves
``k_s``/``v_s``) and MLA latent nodes ({"latent", "k_rope", "len"}, under
KV-VQ also ``latent_s``) are pageable: the dense and MoE families' only
nodes (a ``"pre"`` subtree pages like ``"body"``, Whisper's ``"self"``
and Vision's ``"self0"``... likewise). Every other leaf is pass-through
state of a fixed size a slot (xLSTM's recurrent state, RecurrentGemma's
``h``/``conv`` beside its rings, the cross memories: Whisper's
``cross_k``/``cross_v``/``cross_len``, Vision's ``cross`` node of
``xk``/``xv``/``xlen``; (L, B, ...), batch on axis 1): it keeps its contiguous shape, zeroed, as
the reference's, and takes no block (``bytes_per_block`` counts arenas
only). A paged prefill and ``merge_slot`` write the slot's column of it,
an update shorter than the slot's capacity (a cross memory of as many
rows as there were frames) at its leading rows [0, n) (``anchored``);
a chunk's ``slot_view`` holds the slot's column, sliced at ``slot``.
``paged_state`` is the host half of an engine snapshot.

``page_len`` is a slot's logical capacity: ``max_len``, or for a
sliding-window ring ``min(max_len, window)`` (the contiguous ring's
size), so a ring slot never owns more than ``blocks_per_slot`` blocks;
decode writes position p at ring slot ``p % page_len`` through the
table, and a prefill is ring-converted (``kvcache._to_ring_dynamic``)
before its block write. ``block_size`` divides ``page_len`` (falling
back to the gcd), so the gathered view is exactly the contiguous
cache's ``(B, page_len, ...)``: paged decode runs the same attention
arithmetic as the contiguous path and gives identical tokens.

The port updates in place where the reference returns new trees:
``set_block_tables`` writes the engine's table tensor (a captured decode
graph reads the new table on its next replay), and the prefill and chunk
writes go straight into the shared arenas.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import paged_view
from repro_torch.serve.kvcache import _to_ring_dynamic

# leaf name -> time axis (from the right: leaves carry the layer axis)
_ATTN_TIME_AXES = {"k": -3, "v": -3, "k_s": -2, "v_s": -2}
_MLA_TIME_AXES = {"latent": -2, "k_rope": -2, "latent_s": -2}


def _time_axes(node: dict) -> Optional[Dict[str, int]]:
    """The pageable leaves' time axes of a cache node: an attention node
    ({"k", "v", "len"}) or an MLA node ({"latent", "k_rope", ...}); None
    for any other."""
    if "k" in node and "v" in node and "len" in node:
        return _ATTN_TIME_AXES
    if "latent" in node and "k_rope" in node:
        return _MLA_TIME_AXES
    return None


def effective_block_size(block_size: int, page_len: int) -> int:
    """Largest divisor of ``page_len`` that is <= the requested block size
    (via gcd): divisibility keeps the gathered view ``page_len`` long."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if page_len % block_size == 0:
        return block_size
    return math.gcd(block_size, page_len)


def blocks_for_len(n: int, *, block_size: int, page_len: int) -> int:
    """Blocks needed to hold ``n`` cached positions (capped at the
    slot's ``ceil(page_len / block_size)``)."""
    n = min(max(n, 0), page_len)
    return -(-n // block_size)


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    """Static geometry of a paged cache."""

    block_size: int        # effective positions per block (divides page_len)
    num_blocks: int        # physical blocks in the pool (NB)
    page_len: int          # per-slot logical capacity (= contiguous S)
    blocks_per_slot: int   # W = page_len // block_size
    bytes_per_block: int   # summed over every arena leaf
    sentinel: int          # = num_blocks: the table's "no block" id

    def blocks_for(self, n: int) -> int:
        return blocks_for_len(n, block_size=self.block_size,
                              page_len=self.page_len)


class BlockPool:
    """Host-side LIFO free list over physical block ids: ``alloc`` after
    ``free`` hands the ids back in reverse-free order, so the allocation
    sequence is deterministic and ``state``/``restore`` replay it."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        # pop() from the tail: ids come out 0, 1, 2, ...
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._free_set = set(self._free)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """All or nothing: ``n`` block ids, or None when the pool cannot
        supply them (the caller preempts or defers admission)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Return ids to the pool. ValueError on an out-of-range id or a
        double free: both are ownership bugs and stay loud."""
        for b in blocks:
            if not (0 <= b < self.num_blocks):
                raise ValueError(f"block id {b} out of range "
                                 f"[0, {self.num_blocks})")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)
            self._free_set.add(b)

    def state(self) -> Tuple[int, ...]:
        """The exact free-list order."""
        return tuple(self._free)

    def restore(self, free: Sequence[int]) -> None:
        """Replace the free list with a ``state()``. ValueError on
        duplicate or out-of-range ids."""
        free = [int(b) for b in free]
        if len(set(free)) != len(free):
            raise ValueError("pool snapshot contains duplicate block ids")
        for b in free:
            if not (0 <= b < self.num_blocks):
                raise ValueError(f"pool snapshot block id {b} out of range")
        self._free = free
        self._free_set = set(free)


def paged_state(tables: np.ndarray, pool: BlockPool,
                owned: Sequence[Sequence[int]]) -> Dict[str, Any]:
    """The paging state a snapshot keeps on the host: the host's tables,
    the pool's free list and each slot's owned blocks in order (the
    arenas and the device tables are cache leaves)."""
    return {"block_tables": np.array(tables, dtype=np.int32, copy=True),
            "pool_free": pool.state(),
            "owned": tuple(tuple(int(b) for b in o) for o in owned)}


def _walk(node: Any, page, keep) -> Any:
    """A cache tree with ``page`` applied to every pageable (attention or
    MLA) node and ``keep`` to every pass-through leaf."""
    if isinstance(node, dict):
        if _time_axes(node) is not None:
            return page(node)
        return {k: _walk(v, page, keep) for k, v in node.items()}
    return keep(node)


def make_paging_config(model, num_slots: int, max_len: int, *,
                       window: int = 0, block_size: int = 16,
                       num_blocks: Optional[int] = None,
                       kv_int8: bool = False, kv_int4: bool = False,
                       kvq=None) -> PagingConfig:
    """The pool geometry of ``model`` at ``num_slots`` x ``max_len``
    (``window > 0``: rings of ``min(max_len, window)`` positions).
    ``num_blocks`` defaults to ``num_slots * blocks_per_slot``, the
    contiguous cache's capacity, now shared. ``kv_int8`` / ``kv_int4`` /
    ``kvq`` select the compressed layouts; ``bytes_per_block`` sums every
    arena leaf of that layout (0 for a model with pass-through state
    only): the port's own bytes, so an int4 value counts half a byte
    where the reference's ``jnp.int4`` leaves count one."""
    page_len = min(max_len, window) if window else max_len
    bs = effective_block_size(block_size, page_len)
    W = page_len // bs
    if num_blocks is None:
        num_blocks = num_slots * W
    if num_blocks < W:
        raise ValueError(
            f"num_blocks={num_blocks} cannot hold even one full slot "
            f"(blocks_per_slot={W})")
    specs = model.init_cache(num_slots, max_len, device="meta",
                             **_cache_kw(kv_int8, kvq, kv_int4))
    per_block = 0

    def count(node):
        nonlocal per_block
        for name, t in _time_axes(node).items():
            if name in node:
                leaf = node[name]
                B, S = leaf.shape[t - 1], leaf.shape[t]
                per_block += (leaf.numel() // (B * S)) * bs * leaf.element_size()
        return node

    _walk(specs, count, lambda leaf: leaf)
    return PagingConfig(block_size=bs, num_blocks=num_blocks,
                        page_len=page_len, blocks_per_slot=W,
                        bytes_per_block=per_block, sentinel=num_blocks)


def _cache_kw(kv_int8: bool, kvq, kv_int4: bool = False) -> dict:
    """The cache layout kwargs, passed only when set (model stubs need
    not take them)."""
    kw = {}
    if kv_int8:
        kw["kv_int8"] = True
    if kv_int4:
        kw["kv_int4"] = True
    if kvq is not None:
        kw["kvq"] = kvq
    return kw


def init_paged_cache(model, num_slots: int, max_len: int,
                     meta: PagingConfig, *, device, kv_int8: bool = False,
                     kv_int4: bool = False, kvq=None) -> Any:
    """The paged decode cache, zeroed: each attention (or MLA latent)
    leaf becomes an arena ``(L, NB + 1, bs, ...)`` (the last block the
    sink), ``len`` stays ``(L, B)``, and a sentinel-filled
    ``block_table`` ``(L, B, W)`` int32 joins the node; a pass-through
    leaf keeps its shape (zeros, as the reference's: a prefill writes a
    slot's row before anything reads it)."""
    specs = model.init_cache(num_slots, max_len, device="meta",
                             **_cache_kw(kv_int8, kvq, kv_int4))

    def page(node):
        out = {}
        axes = _time_axes(node)
        for name, leaf in node.items():
            t = axes.get(name)
            if t is None:  # "len"
                out[name] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                        device=device)
                continue
            t %= leaf.dim()
            if leaf.shape[t] != meta.page_len:
                raise ValueError(
                    f"cache leaf {name!r} has time length {leaf.shape[t]}, "
                    f"the paging geometry expects {meta.page_len}")
            shape = (leaf.shape[:t - 1] + (meta.num_blocks + 1,
                                           meta.block_size)
                     + leaf.shape[t + 1:])
            out[name] = torch.zeros(shape, dtype=leaf.dtype, device=device)
        lead, B = tuple(node["len"].shape[:-1]), node["len"].shape[-1]
        out["block_table"] = torch.full(lead + (B, meta.blocks_per_slot),
                                        meta.sentinel, dtype=torch.int32,
                                        device=device)
        return out

    return _walk(specs, page, lambda leaf: torch.zeros(
        leaf.shape, dtype=leaf.dtype, device=device))


def is_paged(caches: Any) -> bool:
    """True when the cache tree holds a block table."""
    return any("block_table" in n for n in attn_nodes(caches))


def attn_nodes(caches: Any) -> List[dict]:
    """The attention and MLA nodes of a cache tree, in order (in a paged
    tree, each with its arenas and block table)."""
    if isinstance(caches, dict):
        if _time_axes(caches) is not None:
            return [caches]
        return [n for v in caches.values() for n in attn_nodes(v)]
    return []


def _node_pairs(old: Any, new: Any) -> List[Tuple[Any, Any]]:
    """The pageable nodes and pass-through leaves of ``old``, each beside
    the node or leaf at the same path of ``new`` (matched by key,
    whatever the trees' key order)."""
    if not isinstance(old, dict) or _time_axes(old) is not None:
        return [(old, new)]
    return [pair for k, v in old.items() for pair in _node_pairs(v, new[k])]


def passthrough_leaves(caches: Any) -> List[torch.Tensor]:
    """The pass-through leaves of a cache tree (every leaf outside its
    attention and MLA nodes), in order."""
    return [t for t, _ in _node_pairs(caches, caches)
            if isinstance(t, torch.Tensor)]


def anchored(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """The part of a pass-through leaf ``old`` (batch on axis 1) that an
    update ``new`` covers: each axis past the batch narrowed to ``new``'s
    extent, from 0 (a view), as the reference's ``dynamic_update_slice``
    anchors an update shorter than the leaf."""
    for ax in range(2, new.dim()):
        if new.shape[ax] != old.shape[ax]:
            old = old.narrow(ax, 0, new.shape[ax])
    return old


def set_block_tables(caches: Any, tables: np.ndarray) -> None:
    """Write ``tables`` (B, W) into every ``block_table`` leaf, broadcast
    over the layer axis, in place. The engine masks non-active rows to
    the sentinel first, so a decode step's writes for free and
    mid-prefill slots go to the sink."""
    for node in attn_nodes(caches):
        bt = node["block_table"]
        src = torch.from_numpy(np.ascontiguousarray(tables, np.int32))
        bt.copy_(src.to(bt.device).expand_as(bt))


def slot_view(caches: Any, slot: torch.Tensor, bt_row: torch.Tensor,
              hist: torch.Tensor, chunk_true: torch.Tensor) -> Any:
    """A one-slot (B = 1) view of the paged cache for a chunked-prefill
    step, made on the device from tensors (no host sync): the arenas are
    shared, ``block_table`` is ``bt_row`` (W,) on every layer, ``len`` is
    ``hist`` (1,), the host's committed length (decode steps in between
    add to every lane's ``len``, so the device leaf is not trusted
    mid-prefill), and a ``prefill_len`` leaf carries the chunk's true
    length ``chunk_true`` (1,) into ``attention_fwd``. Each pass-through
    leaf is its column ``slot`` (a (1,) int64 tensor; a copy, as the
    reference's ``dynamic_slice``)."""

    def page(node):
        L = node["len"].shape[0]
        out = {n: t for n, t in node.items()
               if n not in ("block_table", "len")}
        out["block_table"] = bt_row.to(torch.int32)[None, None].expand(
            L, 1, bt_row.shape[-1]).contiguous()
        out["len"] = hist.to(node["len"].dtype).reshape(1, 1).expand(
            L, 1).contiguous()
        out["prefill_len"] = chunk_true.to(torch.int32).reshape(1, 1).expand(
            L, 1).contiguous()
        return out

    return _walk(caches, page, lambda leaf: leaf.index_select(1, slot))


def merge_slot(caches: Any, new_caches: Any, slot: torch.Tensor) -> None:
    """Fold a chunk step's view back into the full cache, in place: the
    arenas were written through shared storage, the full table is kept,
    ``prefill_len`` dropped, and the view's ``len`` goes into column
    ``slot`` (a (1,) int64 tensor) of every layer, as does the view's
    column of each pass-through leaf (at its leading rows when shorter:
    ``anchored``)."""
    for old, new in _node_pairs(caches, new_caches):
        if isinstance(old, torch.Tensor):
            anchored(old, new).index_copy_(1, slot, new.to(old.dtype))
        else:
            old["len"].index_copy_(1, slot, new["len"].to(old["len"].dtype))


def write_prefill_into_blocks(caches: Any, fresh: Any, slot: torch.Tensor,
                              bt_row: torch.Tensor, true_len: torch.Tensor,
                              meta: PagingConfig, *, window: int = 0) -> None:
    """Commit a fresh one-request prefill cache (batch 1, its time axis a
    bucket of P <= page_len positions) into the paged cache, in place:
    the first ``true_len`` positions of every arena leaf go through
    ``bt_row`` (W,), the rest to the sink; ``len`` of column ``slot``
    (a (1,) int64 tensor) becomes ``true_len`` ((1,) int32). With
    ``window > 0`` each leaf is first ring-converted
    (``_to_ring_dynamic``: any P; its first ``min(true_len, page_len)``
    ring slots are written). A pass-through leaf's column goes into
    column ``slot``, at its leading rows when shorter (``anchored``).
    Every index is a tensor: no host sync, so a CUDA graph can hold
    it."""
    bs, W = meta.block_size, meta.blocks_per_slot
    bt_row = bt_row.to(torch.int32)

    def commit(old, new):
        for name, t in _time_axes(old).items():
            if name not in old:
                continue
            arena, x = old[name], new[name]
            t %= x.dim()
            if window:
                x = _to_ring_dynamic(x, t, meta.page_len, true_len)
            vals = x.select(t - 1, 0)         # drop the batch axis
            P = vals.shape[t - 1]
            i = torch.arange(P, device=arena.device)
            n_valid = true_len.clamp(max=meta.page_len)
            phys = torch.where(i < n_valid, bt_row[(i // bs).clamp(max=W - 1)],
                               meta.sentinel).long()
            lead = (slice(None),) * (t - 1)
            arena[lead + (phys, i % bs)] = vals.to(arena.dtype)
        L = old["len"].shape[0]
        old["len"].index_copy_(1, slot, true_len.to(old["len"].dtype)
                               .reshape(1, 1).expand(L, 1))

    for old, new in _node_pairs(caches, fresh):
        if isinstance(old, torch.Tensor):
            anchored(old, new).index_copy_(1, slot, new.to(old.dtype))
        else:
            commit(old, new)


def gather_block_view(arena: torch.Tensor, block_table: torch.Tensor
                      ) -> torch.Tensor:
    """The per-slot contiguous view of one layer's arena (the sink
    excluded): ``models.common.paged_view``, sentinel ids clamped to
    block NB - 1 as the reference's ``mode="clip"``."""
    return paged_view(arena, block_table)
