"""Tile model and shared-memory layout of the two EVA lookup kernels,
``fused_vq_matmul`` (B1, output codebook recomputed in the kernel) and
``oc_lookup`` (B5, output codebook read from device memory); both
kernels include ``csrc/eva_lookup.cuh``, which this module mirrors.
``cluster_slots`` asks the card how many clusters of each launch shape
it holds at once, which ``lookup_tiles`` prices.

Layout (the paper's conflict-free lookup order). A CTA of 512 threads
owns a tile of ``bn`` output columns, up to 4 rows of M and a range of
V. It walks that range in slabs of ``vl`` rows. Each lane owns one row
``v`` of the slab (its table, as each sublane row owns one in the TPU
kernel) and a run of columns. The slab's output codebook O lives in
shared memory entry-major: one 128-byte line per (c, e) holding the 32
(v, m) slots of that entry, ``mw`` rows of M beside each other
(``mw`` = 1, 2 or 4, so ``vl * mw == 32``). A lane's load of its ``mw``
values of entry e starts at word ``(c*256 + e)*32 + vl*mw``: the bank
it reads depends on its row alone, never on the index it looks up, and
the lanes of one access phase (32 / mw lanes) hold distinct rows.
The slab's index rows are staged by ``cp.async`` in a ring of
``stages`` tiles, each row padded by 16 bytes so that lanes on
different rows at one column read distinct bank groups.

The sums over V then cross lanes: a fixed xor butterfly over the ``vl``
lanes of a column group, then over the ``cs`` CTAs of a thread-block
cluster in rank order (distributed shared memory), then, where one
cluster of at most 8 CTAs cannot fill the card, over ``groups``
clusters in order by a second launch. ``ref.lookup_in_kernel_order``
repeats that order in plain torch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

THREADS = 512                  # threads per CTA, one CTA per SM
WARPS = THREADS // 32
LINE = 32                      # floats per (c, e) line: vl * mw
MT = 4                         # rows of M per CTA
KC = 256                       # entries per codebook (n = 8)
D = 8                          # VQ vector dimension
PAD = 16                       # bytes added to each staged index row
SMEM_MAX = 232448              # dynamic shared memory a block may use
CS_MAX = 8                     # CTAs per cluster (the portable maximum)
STAGES_MAX = 4                 # index tiles in flight
# bn. The recompute costs 2*256*8/bn flops a lookup, so 512 wins only
# where the modelled time, which prices it, is lower
COLUMN_TILES = (1024, 512)
# Cost model of a launch (ns), fitted by ``python3 -m
# repro_torch.kernels.eva_lookup.sweep`` to the time of every launch
# shape of each kernel at llama2-7b's decode linears x M 1/2/3/4/8 on an
# NVIDIA H100 80GB HBM3 (700 W):
#   waves x (call + slabs a CTA x C/2 x (columns x bn/1024
#            + index x bn/1024/mw + slab)) + reduce where groups > 1
# columns: a slab's lookups (C*bn*128 bytes of shared memory); index:
# its index rows (C*vl*bn bytes, vl = 32/mw); slab: making its output
# codebook (B1: recomputed, B5: loaded) and its barriers; call, per wave:
# the launch, the first stage's latency and the cluster sum; reduce: the
# second launch.
COST_TERMS = ("call", "reduce", "columns", "index", "slab")
COST_NS = {True: (4650, 7560, 1260, 2580, 1550),     # fused_vq_matmul
           False: (3630, 7740, 1380, 3680, 2340)}    # oc_lookup


def lane_width(M: int) -> int:
    """Rows of M each lane reads per lookup: 1, 2 or 4 (M >= 3 padded)."""
    return 1 if M == 1 else 2 if M == 2 else 4


class LookupTiles(NamedTuple):
    bn: int                    # output columns per CTA
    mw: int                    # rows of M per lookup (lane_width)
    vl: int                    # rows of V per slab, one per lane of a group
    stages: int                # index tiles in the cp.async ring
    cs: int                    # CTAs per cluster: V splits summed on chip
    groups: int                # clusters per column tile (> 1: second launch)
    slabs_per_split: int       # slabs each CTA walks
    smem: int                  # dynamic shared memory bytes

    @property
    def splits(self) -> int:
        return self.cs * self.groups

    @property
    def cols_per_lane(self) -> int:
        return self.bn // (WARPS * self.mw)


def smem_bytes(C: int, mw: int, bn: int, stages: int, recompute: bool) -> int:
    """The transposed codebooks (recompute only), the O slab (C*32 KB)
    and ``stages`` index tiles (C*vl rows of bn + PAD bytes, plus the x
    slab when recomputing) — as ``eva_lookup.cuh`` lays them out."""
    vl = LINE // mw
    stage = C * vl * (bn + PAD) + (mw * vl * D * 4 if recompute else 0)
    return ((C * KC * D * 4 if recompute else 0) + C * KC * LINE * 4
            + stages * stage)


def stages_for(C: int, mw: int, bn: int, recompute: bool) -> int:
    """Index stages that fit shared memory beside the O slab (0: none)."""
    stages = STAGES_MAX
    while stages and smem_bytes(C, mw, bn, stages, recompute) > SMEM_MAX:
        stages -= 1
    return stages


def cost_terms(C: int, mw: int, bn: int, groups: int, sps: int,
               waves: int) -> Tuple[float, ...]:
    """The terms of the cost model (``COST_TERMS``) for a launch of
    ``waves`` waves whose CTAs walk ``sps`` slabs each."""
    slabs = waves * sps * C / 2
    return (waves, float(groups > 1), slabs * bn / 1024,
            slabs * bn / 1024 / mw, slabs)


def candidates(M: int, V: int, N: int, C: int, sm_count: int,
               recompute: bool, slots: Optional[Tuple[int, ...]] = None):
    """Every launch shape worth pricing, with the waves it takes: each
    column tile that fits shared memory with at least one index stage,
    each cluster size the card can hold, and for each count of slabs a
    CTA walks, the fewest clusters per tile that cover V.
    ``slots[i * CS_MAX + cs - 1]`` is how many clusters of ``cs`` CTAs
    with column tile ``COLUMN_TILES[i]`` the card holds at once (the
    kernels' ``*_max_clusters``); by default ``sm_count // cs``."""
    mw = lane_width(M)
    vl = LINE // mw
    slabs = -(-V // vl)
    m_tiles = -(-M // MT)
    for bi, bn in enumerate(COLUMN_TILES):
        stages = stages_for(C, mw, bn, recompute)
        if not stages:
            continue
        tiles = -(-N // bn) * m_tiles
        smem = smem_bytes(C, mw, bn, stages, recompute)
        for cs in range(1, min(CS_MAX, slabs) + 1):
            held = (slots[bi * CS_MAX + cs - 1] if slots is not None
                    else sm_count // cs)
            if held < 1:
                continue
            seen = set()
            for groups in range(1, -(-slabs // cs) + 1):
                sps = -(-slabs // (cs * groups))
                if sps in seen:
                    continue
                seen.add(sps)
                yield (LookupTiles(bn, mw, vl, stages, cs, groups, sps, smem),
                       -(-tiles * groups // held))


@functools.lru_cache(maxsize=None)
def lookup_tiles(M: int, V: int, N: int, C: int, sm_count: int,
                 recompute: bool,
                 slots: Optional[Tuple[int, ...]] = None) -> LookupTiles:
    """The launch shape of a lookup kernel: of ``candidates``, the least
    modelled time (``COST_NS`` x ``cost_terms``), ties to wider tiles and
    fewer splits."""
    best = None
    for t, waves in candidates(M, V, N, C, sm_count, recompute, slots):
        ns = sum(k * f for k, f in zip(
            COST_NS[recompute],
            cost_terms(C, t.mw, t.bn, t.groups, t.slabs_per_split, waves)))
        key = (ns, -t.bn, t.splits)
        if best is None or key < best[0]:
            best = (key, t)
    if best is None:
        raise ValueError(f"no lookup tile fits shared memory at C={C}")
    return best[1]


def grid_ctas(t: LookupTiles, M: int, N: int) -> int:
    """CTAs of a launch: column tiles x V splits x tiles of M."""
    return -(-N // t.bn) * t.splits * -(-M // MT)


@functools.lru_cache(maxsize=None)
def cluster_slots(name: str, device_index: int, M: int, C: int,
                  recompute: bool) -> Tuple[int, ...]:
    """How many clusters of each size, at each column tile, the card
    holds at once for kernel ``name`` (``fused_vq_matmul`` or
    ``oc_lookup``) at this M and C, from cudaOccupancyMaxActiveClusters;
    laid out as ``lookup_tiles`` reads them."""
    fn = build.bind(name, f"{name}_max_clusters", 1, 5)
    mw = lane_width(M)
    out = ctypes.c_int(0)
    held = []
    with torch.cuda.device(device_index):
        for bn in COLUMN_TILES:
            stages = stages_for(C, mw, bn, recompute)
            for cs in range(1, CS_MAX + 1):
                if not stages:
                    held.append(0)
                    continue
                out.value = 0
                build.check(fn(ctypes.addressof(out), M, C, bn, stages, cs,
                               None), f"{name} occupancy")
                held.append(out.value)
    return tuple(held)


# ---------------------------------------------------------------------------
# Mirrors of the kernel's shared-memory offsets (for the bank checks)
# ---------------------------------------------------------------------------


def lane_coords(lane: int, mw: int):
    """(row of the slab, column group within the warp) of a lane."""
    vl = LINE // mw
    return lane % vl, lane // vl


def o_slot_byte(c: int, e: int, row: int, mw: int) -> int:
    """Byte offset of the ``mw`` values a lane on slab row ``row`` loads
    for entry ``e`` of codebook ``c`` (also where the O slab is written)."""
    return ((c * KC + e) * LINE + row * mw) * 4


def index_byte(c: int, row: int, col: int, mw: int, bn: int) -> int:
    """Byte offset of index I[c, slab row, tile column] in a staged tile."""
    return (c * (LINE // mw) + row) * (bn + PAD) + col
