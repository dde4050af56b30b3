"""Continuous-batching serving engine (``repro/serve/engine.py``), with
its resilience layer (``serve/resilience.py``).

Prefill runs per request at its power-of-two length bucket (every VQ
linear through the dequant kernel; dense linears through the INT8 GEMM
under ``PlanPolicy.int8_prefill``); decode runs as one batched step over
all slots (every VQ linear through the EVA backend the planner ranks
first — the fused kernel, unless a calibration prices the vq_gemm +
oc_lookup split below it — attention through flash-decode), so every
streamed index tile serves every active request. Free slots are fed
token 0 at position 0, as the reference feeds them; in a MoE step they
take expert capacity like any token. At construction every linear is
pre-planned at the decode and prefill shapes (``Engine.plans``; a MoE
layer's experts at M = their capacity for that many tokens) and the
plans and rankings are logged.

MoE capacity routing depends on the token count, so a MoE model's
prefill is not bucketed (``_BUCKETABLE_FAMILIES``, as the reference):
it runs at the exact prompt length, eagerly (``graphs.EagerStep``: a
graph per length would be captured for about one use), and
``trace_counts["prefill"]`` counts the distinct lengths, as the
reference counts its retraces; prefill is pre-planned at ``max_len``
(``plans["prefill@cap"]``, the reference's estimate). A sliding-window
model's caches are rings (``min(max_len, window)`` positions, every
layout); its requests need only a prompt that fits ``max_len``: decode
wraps the ring. Chunked prefill and speculation stay off for both, as
in the reference. An MLA model (deepseek-v2, a MoE) caches a latent a
token (fp or KV-VQ; it has no int8 layout, so kv_bits=8 raises, as in
the reference) and its dense prefix layers' caches form a ``"pre"``
subtree beside ``"body"``, which slot insertion, paging, snapshots and
the graphs walk like it. An xLSTM model's cache is recurrent state of a
fixed size a slot, with no ``len`` leaf and no attention: its prefill
integrates pad tokens, so it runs at the exact prompt length too; slot
insertion overwrites a slot's state at admission (a preempted request's
state is rebuilt by its re-prefill); a paged engine keeps the state
contiguous (pass-through) and pages nothing; ``kv_bits`` must be 16, as
in the reference. A RecurrentGemma model's cache is one tree of both:
local-attention rings of ``min(max_len, local_window)`` positions (the
window comes from ``local_window``) beside RG-LRU state (``h``,
``conv``); it prefills eagerly at the exact length, its slot insertion
ring-converts the rings and overwrites the state, a paged engine pages
the rings through the block table and keeps the state pass-through,
``kv_bits`` must be 16 and ``speculate_k`` is refused (the windowed
cache's check comes first), as in the reference. A Whisper model
prefills from the engine's ``extras`` beside the tokens: one set of
frames (``extras={"frames": (S_src, d_model)}``), batched once at
construction and kept on the device, which every prefill reads (the
bucket graphs, the paged prefill and each chunk continuation, which
re-encodes them, as the reference's). Its cache holds the self-attention
rows beside cross memories that a prefill writes once and decode only
reads: a prefill's memories (as many rows as frames) go into a slot's
leading rows (``paging.anchored``); a paged engine pages the
self-attention and keeps the memories pass-through; ``kv_bits`` must be
16 and ``speculate_k`` is refused, as in the reference. A
Llama-3.2-Vision model is served the same way from one image
(``extras={"image_embeds": (n_img, d_model)}``, projected again by every
prefill and chunk): its self-attention caches page, its image memories
(``cross``: ``xk``/``xv``/``xlen``, n_img rows at a slot's leading rows
of N_IMG_TOKENS) pass through.

``EngineConfig.kv_bits`` selects the KV cache layout: 16 = fp, 8 = int8
values + bf16 scales (attended through plain torch), 4/2 = KV-VQ uint8
codebook indices + bf16 scales (the grid codebooks attach to the params;
decode attention through the KV-VQ flash-decode kernel). Prefill runs in
fp and its cache is quantized explicitly before slot insertion.

    uid = engine.submit(GenerationRequest(...))
    events = engine.step()
    for ev in engine.stream(uid): ...
    engine.generate(prompts, n)

Each step is compiled once, as the reference jits it: on a CUDA device
the decode step is captured as a CUDA graph at construction and each
prefill bucket at its first use (``serve/graphs.StepGraph``; the buckets
share one memory pool), and every decode step and every prefill is one
replay over static input buffers.
On the CPU the same step functions run uncaptured.
``trace_counts["decode"]`` counts builds of the decode step (one per
engine) and ``trace_counts["prefill"]`` the prefill buckets built so
far. The decode graph covers the model's decode through the logits of
the real vocabulary; sampling and stopping run eagerly on those logits,
and tokens, stop flags and logprobs come back in one readback. A
prefill graph covers the model's prefill at its bucket and, under
``kv_bits < 16``, the cache's quantization; the first token's sample
and the slot insertion run eagerly.

``EngineConfig.paged`` swaps the per-slot contiguous cache for block
arenas and block tables (``serve/paging.py``): admission allocates the
prompt's blocks, decode grows a slot a block at a time, a finished
request frees its blocks, and a decode step that finds the pool empty
preempts the youngest request back to the head of the queue (it resumes
by re-prefilling its prompt and generated tokens, its generator and
budget restored, so its stream is the one an uninterrupted run gives).
With ``prefill_chunk`` a longer prompt is prefilled a chunk a tick,
interleaved with decode (fp caches only, as the reference). Tables
change in place, so the decode graph is still captured once; the paged
prefill of each bucket and each chunk-continuation bucket is a graph
built at first use (``trace_counts["prefill"]``,
``trace_counts["prefill_chunk"]``), its slot, table row, committed
length and true length static inputs.

``EngineConfig.speculate_k = K > 0`` makes every decode step a K-draft
verify window (``serve/speculative.py``): the decode graph, still built
once, drafts from the per-slot successor table ``succ`` (a device buffer
the eager part updates in place: a replay reads fixed addresses) and
runs the model over K + 1 tokens a slot, through (B, K + 1, vocab)
logits; the eager part samples each row with the slots' generators,
keeps the accepted prefix, rolls the caches' ``len`` and the generators
back to it and records the emitted transitions, and up to K + 1 tokens a
slot come back in the one readback. Streams are the ones ``speculate_k=0``
gives.

The resilience layer, as the reference's: ``EngineConfig.fault_plan``
fires scripted faults at five boundaries (``resilience.BOUNDARIES``); a
lane whose logits go non-finite finishes "error" while the batch streams
on, and ``breaker_k`` poisoned steps in a row trip the circuit breaker
(the queue is rejected, submits refused); ``queue_ttl_s`` and the
requests' deadlines time work out; a decode step slower than
``straggler_threshold`` x the median counts in ``straggler_steps``;
``snapshot()`` / ``restore()`` carry the whole engine through the host,
so a fresh engine resumes a crashed one's streams exactly
(``resilience.serve_with_restarts``). The graphs read the caches, the
successor table and the block tables at fixed addresses, so a restore
copies into them and never rebinds them. A poison is added to the
logits the graphs return, in the eager epilogue, and only when a plan
is set. A ``backend`` fault quarantines the decode plan's backend in the
default planner (``core/plan.py``), re-plans, rebuilds the decode graph
over the live caches (kept bit for bit) and drops the prefill graphs,
which rebuild at first use. A kernel's own exception is never caught:
it raises out of ``step()``.

``Engine.tracer`` records spans of ``step()``'s phases (sweep, each
admission and prefill, the decode step's graph, epilogue, readback and
events, delivery) and, on CUDA, device marks around the graph calls and
the eager epilogues (``serve/tracing.py``). It is off unless the caller
sets a ``tracing.Tracer``; off, a span costs a shared no-op context, or
a ``record_function`` range under an outside profiler.
``EngineMetrics.prefill_bucket_tokens`` counts the tokens prefill steps
ran, padding included, beside ``prefill_prompt_tokens``.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device, tensor_device
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.core import plan as plan_mod
from repro_torch.core.quantize import attach_kv_codebooks, kv_codebook_tree
from repro_torch.core.vq import KVQuantConfig
from repro_torch.models.api import PREFILL_EXTRAS, Model
from repro_torch.models.common import RunConfig, moe_capacity
from repro_torch.runtime.fault_tolerance import StepWatchdog
from repro_torch.serve import api, paging, speculative, tracing
from repro_torch.serve.api import (GenerationRequest, RequestEvicted,
                                   RequestOutput, SamplingParams, StreamEvent)
from repro_torch.serve.graphs import (EagerStep, HostInputs, StepGraph,
                                      tensor_leaves)
from repro_torch.serve.kvcache import (cache_bytes, encode_prefill_cache,
                                       pad_prefill_cache,
                                       quantize_prefill_cache_int8)
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.resilience import (CircuitBreaker, EngineSnapshot,
                                          FaultPlan, InjectedFault)
from repro_torch.serve.scheduler import QueueFull, Scheduler, TrackedRequest

log = logging.getLogger(__name__)

# prompts pad to power-of-two length buckets from this size up to max_len
MIN_PREFILL_BUCKET = 8
# families whose prefill is invariant to causal right-padding; MoE
# capacity routing depends on the token count, so it prefills at the
# exact prompt length (the reference's list)
_BUCKETABLE_FAMILIES = ("dense", "whisper", "vision")


def _insert_slot(batched: Any, single: Any, b: int) -> None:
    """Copy a batch-1 cache tree (batch on axis 1) into slot ``b``; a leaf
    shorter than the slot's (a cross memory of as many rows as there
    were frames) at its leading rows, as the reference's
    ``dynamic_update_slice`` anchors it (``paging.anchored``)."""
    if isinstance(batched, dict):
        for k, v in batched.items():
            _insert_slot(v, single[k], b)
    else:
        paging.anchored(batched, single)[:, b].copy_(single[:, 0])


@dataclasses.dataclass
class EngineConfig:
    num_slots: int = 4
    max_len: int = 256
    max_queue: int = 256               # submit() rejects past this bound
    max_retained: int = 1024           # finished outputs kept for output()
    # ---- resilience (serve/resilience.py) ----
    # queued requests older than this time out at the tick's sweep
    queue_ttl_s: Optional[float] = None
    # stream() raises after this long without an event for its uid
    stream_stall_s: float = 60.0
    # this many consecutive poisoned steps trip the circuit breaker
    breaker_k: int = 3
    # decode steps slower than this x the rolling median are stragglers
    straggler_threshold: float = 3.0
    # scripted faults (tests and drills); None in production
    fault_plan: Optional[FaultPlan] = None
    # paged KV memory (serve/paging.py): block arenas + per-slot tables;
    # memory follows the requests' lengths, and a decode step out of
    # blocks preempts the youngest request instead of failing
    paged: bool = False
    block_size: int = 16               # positions a block (gcd-snapped)
    num_blocks: Optional[int] = None   # None: num_slots x blocks a slot
    # chunked prefill (paged, kv_bits=16): prompts longer than this are
    # prefilled a chunk a tick, interleaved with decode; None disables
    prefill_chunk: Optional[int] = None
    # bits per stored KV channel: 16 = fp, 8 = int8 + k_s/v_s scales,
    # 4/2 = KV-VQ (uint8 codebook indices; codebooks attach to params)
    kv_bits: int = 16
    # K > 0: every decode step verifies K drafts a slot in one K + 1 token
    # window (serve/speculative.py); the streams are those of K = 0. The
    # dense family with full attention only, as the reference; a request
    # opts out with GenerationRequest.speculate=False
    speculate_k: int = 0


class Engine:
    def __init__(self, model: Model, params: Any, rc: RunConfig,
                 ecfg: EngineConfig, extras: Optional[Dict[str, Any]] = None,
                 *, device: DeviceLike = None):
        """``extras``: the prefill's inputs beside the tokens, one set for
        every request (whisper: ``{"frames": (S_src, d_model)}``; vision:
        ``{"image_embeds": (n_img, d_model)}``), arrays or tensors,
        batched once as the reference does (a 2-D value gets a batch
        axis, any other keeps its first row).

        Raises:
          ValueError: an unsupported ``kv_bits`` or ``speculate_k`` (the
            reference's messages), params off the engine's device, or a
            whisper model without ``frames`` or a vision model without
            ``image_embeds``."""
        if ecfg.kv_bits not in (16, 8, 4, 2):
            raise ValueError(
                f"kv_bits={ecfg.kv_bits} unsupported; expected 16/8/4/2")
        if ecfg.kv_bits != 16 and model.cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"kv_bits={ecfg.kv_bits} requires an attention-cache "
                f"family (dense/moe), got {model.cfg.family!r}")
        if ecfg.kv_bits == 8 and model.cfg.use_mla:
            raise ValueError(
                "kv_bits=8 has no MLA latent layout; use 16 or the KV-VQ "
                "4/2-bit modes")
        self.spec_k = int(ecfg.speculate_k)
        if self.spec_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {self.spec_k}")
        if self.spec_k:
            cfg = model.cfg
            if cfg.sliding_window or cfg.local_window:
                raise ValueError(
                    "speculate_k > 0 requires a full (non-windowed) cache: "
                    "ring caches decode one token at a time")
            if cfg.family != "dense":
                raise ValueError(
                    f"speculate_k > 0 requires family='dense' (MoE capacity "
                    f"routing depends on the token count, breaking "
                    f"token-identity), got {cfg.family!r}")
            if cfg.use_mla:
                raise ValueError(
                    "speculate_k > 0 is not supported with MLA decode")
        self.device = resolve_device(device)
        extras = dict(extras or {})
        for k in PREFILL_EXTRAS.get(model.cfg.family, ()):
            if k not in extras:
                raise ValueError(
                    f"a {model.cfg.family} engine prefills from {k}: pass "
                    f"extras={{'{k}': (rows, d_model)}}")
        # prefill extras (whisper's frames, vision's image), batched once,
        # on the device: tensors every prefill graph reads
        self._extra_batch = {}
        for k, v in extras.items():
            v = torch.as_tensor(v).to(self.device)
            self._extra_batch[k] = v[None] if v.dim() == 2 else v[:1]
        p_dev = tensor_device(params)
        if p_dev is not None and p_dev.type != self.device.type:
            raise ValueError(f"params live on {p_dev}, engine runs on "
                             f"{self.device}")
        # the compressed KV layout; the cache kwargs are passed only when
        # one is active, so model stubs need not accept them
        self.kvq: Optional[KVQuantConfig] = None
        self.kv_int8 = ecfg.kv_bits == 8
        self._cache_kw: Dict[str, Any] = (
            {"kv_int8": True} if self.kv_int8 else {})
        if ecfg.kv_bits in (4, 2):
            self.kvq = KVQuantConfig(kv_bits=ecfg.kv_bits)
            try:  # keep codebooks the caller attached
                self._kv_cb = kv_codebook_tree(params)
            except ValueError:
                params = attach_kv_codebooks(params, model.cfg, self.kvq)
                self._kv_cb = kv_codebook_tree(params)
            rc = rc.replace(kv_vq=self.kvq)
            self._cache_kw["kvq"] = self.kvq
        self.model = model
        self.params = params
        self.rc = rc
        self.ecfg = ecfg
        self.window = model.cfg.sliding_window or model.cfg.local_window
        self._bucketed = model.cfg.family in _BUCKETABLE_FAMILIES
        self.sched = Scheduler(ecfg.num_slots, max_queue=ecfg.max_queue)
        self.metrics_counters = EngineMetrics(num_slots=ecfg.num_slots)
        # spans of step() (serve/tracing.py): off unless a caller sets a
        # tracing.Tracer
        self.tracer: Any = tracing.OFF
        B = ecfg.num_slots
        if ecfg.paged:
            self.paging: Optional[paging.PagingConfig] = \
                paging.make_paging_config(
                    model, B, ecfg.max_len, window=self.window,
                    block_size=ecfg.block_size, num_blocks=ecfg.num_blocks,
                    **self._cache_kw)
            self.caches = self._init_cache()
            self.pool: Optional[paging.BlockPool] = paging.BlockPool(
                self.paging.num_blocks)
            # the host's tables and owned ids; the device's table lags
            # until _sync_tables
            self.tables = np.full((B, self.paging.blocks_per_slot),
                                  self.paging.sentinel, np.int32)
            self._owned: List[List[int]] = [[] for _ in range(B)]
            self._tables_dirty = True
            self._update_kv_gauges()
        else:
            self.paging, self.pool, self.tables = None, None, None
            self.caches = self._init_cache()
            # the contiguous cache is allocated once, worst case
            m = self.metrics_counters
            m.kv_bytes_in_use = m.peak_kv_bytes_in_use = cache_bytes(
                self.caches)
        # chunked prefill: paged fp caches of a bucketed family with full
        # attention and no MLA latent only (the continuation cannot append
        # quantized rows, wrap a ring or write a latent), as the
        # reference gates it
        self._chunked = bool(ecfg.paged and ecfg.prefill_chunk
                             and ecfg.kv_bits == 16 and self._bucketed
                             and self.window == 0 and not model.cfg.use_mla)

        self.positions = np.zeros((B,), np.int32)
        self.last_token = np.zeros((B,), np.int32)
        self.temperature = np.ones((B,), np.float32)
        self.top_k = np.zeros((B,), np.int32)
        self.top_p = np.ones((B,), np.float32)
        self.greedy = np.ones((B,), bool)
        self.stop_ids = np.full((B, api.MAX_STOP_IDS), -1, np.int32)
        self.remaining = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)
        self.generators: List[Optional[torch.Generator]] = [None] * B
        # speculative decoding: the per-slot successor table (the drafter)
        # on the device, and whether each slot's request speculates
        self.succ: Optional[torch.Tensor] = None
        self.spec_on = np.ones((B,), bool)
        if self.spec_k:
            self.succ = torch.full((B, model.cfg.vocab_size), -1,
                                   dtype=torch.int32, device=self.device)

        self._outputs: Dict[int, RequestOutput] = {}
        self._buffers: Dict[int, Deque[StreamEvent]] = {}
        self._pending: List[StreamEvent] = []
        self._retired: Deque[int] = deque()

        # the resilience state: the tick (the fault plan's clock and the
        # snapshot's resume point), the breaker and the decode watchdog
        self._tick = 0
        self.fault_plan = ecfg.fault_plan
        self.breaker = CircuitBreaker(ecfg.breaker_k)
        self.watchdog = StepWatchdog(window=50,
                                     threshold=ecfg.straggler_threshold)

        self.trace_counts = {"decode": 0, "prefill": 0}
        if self._chunked:
            self.trace_counts["prefill_chunk"] = 0
        self._buckets = (api.prefill_buckets(ecfg.max_len, MIN_PREFILL_BUCKET)
                         if self._bucketed else ())
        self.prefill_graphs: Dict[int, StepGraph] = {}
        self.chunk_graphs: Dict[int, StepGraph] = {}
        # the prefill buckets' shared graph memory pool (``prefill_graph``)
        self.prefill_pool = (torch.cuda.graph_pool_handle()
                             if self.device.type == "cuda" else None)
        self._rc_decode = rc.replace(mode="decode")
        self._rc_prefill = rc.replace(mode="prefill")
        self.plans = self._preplan()
        # the sampling epilogue's per-slot knobs, fed like a step's inputs
        knobs = {
            "temperature": ((B,), torch.float32), "top_k": ((B,), torch.int32),
            "top_p": ((B,), torch.float32),
            "stop_ids": ((B, api.MAX_STOP_IDS), torch.int32),
            "remaining": ((B,), torch.int32), "active": ((B,), torch.bool)}
        if self.spec_k:
            knobs["spec_on"] = ((B,), torch.bool)
        if self.fault_plan is not None:  # the poison lanes, as data
            knobs["poison"] = ((B,), torch.float32)
        self._knobs = HostInputs(knobs, self.device)
        self.decode_graph = self._make_decode_graph()
        # the build's warm-up wrote into every slot: back to what
        # init_cache makes (sLSTM's n = 1e-6; paged: the sentinel in
        # every table), from a fresh cache made on the host so that the
        # device never holds two
        for t, v in zip(tensor_leaves(self.caches),
                        tensor_leaves(self._init_cache("cpu"))):
            t.copy_(v)

    def _init_cache(self, device: DeviceLike = None) -> Any:
        """A fresh cache of the engine's layout (paged when the engine
        pages), as ``init_cache`` makes it, on ``device`` (default the
        engine's)."""
        kw = {"paging": self.paging} if self.paging is not None else {}
        return self.model.init_cache(self.ecfg.num_slots, self.ecfg.max_len,
                                     device=device or self.device, **kw,
                                     **self._cache_kw)

    def _preplan(self) -> Dict[str, List[Tuple[Tuple[Any, ...], Any]]]:
        """Plan every linear at the shapes it runs at — decode at M =
        num_slots (a MoE layer's experts at their capacity for num_slots
        tokens, an expand MLA decode's ``wkv_b`` at num_slots x max_len),
        prefill at each length bucket or, unbucketed, at max_len
        (``prefill@cap``, the reference's estimate) — warming
        the planner cache, and log each distinct plan and, where more
        than one backend matched, its ranking."""
        cfg = self.model.cfg
        act = cfg.act_dtype

        def site_m(T, decode=False):
            rows = ({"experts": moe_capacity(cfg, T)}
                    if cfg.family == "moe" else {})
            if decode and cfg.use_mla and not self.rc.mla_absorb:
                rows["wkv_b"] = T * max_len       # the whole latent cache
            return rows

        B, max_len = self.ecfg.num_slots, self.ecfg.max_len
        plans = {"decode": plan_mod.preplan_params(
            self.params, self.rc.policy, mode="decode", m=B, act_dtype=act,
            site_m=site_m(B, decode=True))}
        if self._bucketed:
            for m, pl in plan_mod.preplan_prefill_buckets(
                    self.params, self.rc.policy, buckets=self._buckets,
                    act_dtype=act).items():
                plans[f"prefill@{m}"] = pl
        else:
            plans["prefill@cap"] = plan_mod.preplan_params(
                self.params, self.rc.policy, mode="prefill", m=max_len,
                act_dtype=act, site_m=site_m(max_len))
        for phase, pls in plans.items():
            uniq: Dict[str, int] = {}
            rankings: Dict[str, int] = {}
            for _path, pl in pls:
                uniq[pl.describe()] = uniq.get(pl.describe(), 0) + 1
                rk = pl.describe_ranking()
                if rk:
                    rankings[rk] = rankings.get(rk, 0) + 1
            for desc, count in sorted(uniq.items()):
                log.info("%s plan [%d leaves] %s", phase, count, desc)
            for rk, count in sorted(rankings.items()):
                log.info("%s ranking [%d leaves] %s", phase, count, rk)
        return plans

    # ------------------------------------------------------------ admission
    def _admission_error(self, request: GenerationRequest) -> Optional[str]:
        """Why ``request`` can never be served here (None if it can). A
        contiguous full cache needs room for every decode write; a paged
        one admits length-aware: ``max_new_tokens`` is a cap, and the
        budget clamps to the capacity left at activation. A ring
        (windowed) cache wraps, so only the prompt must fit."""
        if request.prompt_len > self.ecfg.max_len:
            return (f"prompt length {request.prompt_len} exceeds max_len "
                    f"{self.ecfg.max_len}")
        need = request.prompt_len + request.max_new_tokens - 1
        if self.window == 0 and need > self.ecfg.max_len:
            if self.paging is None:
                return (f"prompt_len + max_new_tokens - 1 = {need} exceeds "
                        f"the cache capacity max_len={self.ecfg.max_len}")
            need = self.ecfg.max_len
        if self.paging is not None:
            peak = self.paging.blocks_for(need)
            if peak > self.paging.num_blocks:
                return (f"request needs {peak} KV blocks at peak, the pool "
                        f"only has {self.paging.num_blocks} "
                        f"(EngineConfig.num_blocks)")
        return None

    def submit(self, request: GenerationRequest) -> int:
        """Admission-checked submit: an unservable request or a full queue
        rejects at once with a terminal ``finish_reason="rejected"``."""
        if not isinstance(request, GenerationRequest):
            raise TypeError(f"submit() takes a GenerationRequest, got "
                            f"{type(request).__name__}")
        if len(request.stop_set) > api.MAX_STOP_IDS:
            raise ValueError(f"request has {len(request.stop_set)} stop ids; "
                             f"the engine supports at most {api.MAX_STOP_IDS}")
        self.metrics_counters.count_submit()
        if not self.healthy:
            return self._reject(
                f"engine unhealthy: circuit breaker tripped after "
                f"{self.breaker.consecutive} consecutive poisoned steps")
        why = self._admission_error(request)
        if why is not None:
            return self._reject(why)
        try:
            uid = self.sched.submit(request)
        except QueueFull as e:
            return self._reject(str(e))
        self._buffers[uid] = deque()
        return uid

    def _reject(self, why: str) -> int:
        uid = self.sched.next_uid()
        log.info("request %d rejected: %s", uid, why)
        self.metrics_counters.rejected += 1
        self._outputs[uid] = RequestOutput(uid=uid, tokens=(),
                                           finish_reason="rejected")
        self._buffers[uid] = deque()
        self._pending.append(StreamEvent(uid=uid, index=-1, token=None,
                                         finish_reason="rejected"))
        self._retain(uid)
        return uid

    def _retain(self, uid: int) -> None:
        self._retired.append(uid)
        while len(self._retired) > self.ecfg.max_retained:
            old = self._retired.popleft()
            self._outputs.pop(old, None)
            self._buffers.pop(old, None)

    # ------------------------------------------------------------- prefill
    def _sample_row(self, logits: torch.Tensor, slot: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample slot ``slot``'s first token from its (1, V) logits row."""
        dev = logits.device
        tok = api.sample_tokens(
            logits, [self.generators[slot]],
            torch.tensor(self.temperature[slot:slot + 1], device=dev),
            torch.tensor(self.top_k[slot:slot + 1], device=dev),
            torch.tensor(self.top_p[slot:slot + 1], device=dev),
            [bool(self.greedy[slot])])
        return tok, api.token_logprobs(logits, tok)

    def _encoder(self):
        """The quantization of a prefill cache into the engine's layout
        (identity at kv_bits=16); it holds no reference to the engine."""
        kvq, kv_int8 = self.kvq, self.kv_int8
        kv_cb = self._kv_cb if kvq is not None else None

        def encode(cache):
            if kvq is not None:
                return encode_prefill_cache(cache, kv_cb, kvq)
            if kv_int8:
                return quantize_prefill_cache_int8(cache)
            return cache

        return encode

    def prefill_graph(self, bucket: int) -> StepGraph:
        """The prefill step of length bucket ``bucket``, built (on CUDA:
        captured) at its first use, as the reference traces its jitted
        prefill once per bucket: the model's prefill over static (1,
        bucket) tokens and, under kv_bits < 16, the quantization of its
        cache into the engine's layout (slot insertion's ``copy_`` would
        truncate rather than quantize). Returns (fp32 logits (1, bucket,
        padded vocab), cache); on a paged engine the step also takes the
        static ``slot``, ``bt_row`` and ``true_len`` and commits the
        cache into the slot's blocks itself
        (``paging.write_prefill_into_blocks``), returning the logits. The
        step holds no reference to the engine, so a dropped engine frees
        its graphs at once. An unbucketed (MoE) engine's ``bucket`` is
        the exact prompt length and its step an ``EagerStep``: nothing
        is captured. A windowed model's cache is ring-converted: by the
        slot insertion's ``pad_prefill_cache`` (contiguous) or by
        ``write_prefill_into_blocks`` (paged).

        Every bucket captures into ``prefill_pool``: the buckets are
        replayed in any order, which is safe because ``_prefill_one``
        consumes a replay's outputs (sample, pad, insert) before any
        other prefill replays (``serve/graphs``). So the pool holds the
        largest bucket's working memory once, beside each built bucket's
        outputs, where pools of their own would each keep their peak."""
        step = self.prefill_graphs.get(bucket)
        if step is None:
            self.trace_counts["prefill"] += 1
            model, params, rc = self.model, self.params, self._rc_prefill
            encode, extra = self._encoder(), self._extra_batch
            tokens = {"tokens": ((1, bucket), torch.int32)}
            if self.paging is None:
                def prefill(tokens):
                    logits, cache = model.prefill(
                        params, {"tokens": tokens, **extra}, rc)
                    return logits, encode(cache)

                step = (StepGraph(prefill, tokens, self.device,
                                  pool=self.prefill_pool) if self._bucketed
                        else EagerStep(prefill, tokens, self.device))
            else:
                caches, meta, window = self.caches, self.paging, self.window

                def prefill(tokens, slot, bt_row, true_len):
                    logits, cache = model.prefill(
                        params, {"tokens": tokens, **extra}, rc)
                    paging.write_prefill_into_blocks(
                        caches, encode(cache), slot, bt_row, true_len, meta,
                        window=window)
                    return logits

                inputs = {**tokens, **self._slot_inputs(),
                          "true_len": ((1,), torch.int32)}
                step = (self._paged_step(prefill, inputs) if self._bucketed
                        else EagerStep(prefill, inputs, self.device))
            self.prefill_graphs[bucket] = step
        return step

    def chunk_graph(self, bucket: int) -> StepGraph:
        """The chunked-prefill continuation of length bucket ``bucket``,
        built at its first use (``trace_counts["prefill_chunk"]``): the
        model's forward over a one-slot view of the paged cache
        (``paging.slot_view``) at positions ``hist + [0, bucket)`` (with
        the engine's extras: whisper re-encodes its frames, vision
        re-projects its image), its K/V
        written through the slot's table, then the view's ``len`` and
        pass-through leaves merged back (``paging.merge_slot``). Static
        inputs: tokens, slot, bt_row, the committed length ``hist`` and
        the chunk's ``true_len``. Returns the fp32 logits (1, bucket, padded vocab);
        it shares ``prefill_pool`` with the prefill buckets."""
        step = self.chunk_graphs.get(bucket)
        if step is None:
            self.trace_counts["prefill_chunk"] += 1
            model, params, rc = self.model, self.params, self._rc_prefill
            caches, extra = self.caches, self._extra_batch

            def chunk(tokens, slot, bt_row, hist, true_len):
                view = paging.slot_view(caches, slot, bt_row, hist, true_len)
                pos = hist + torch.arange(tokens.shape[1], dtype=torch.int32,
                                          device=tokens.device)[None]
                logits, view = model.forward(
                    params, {"tokens": tokens, "positions": pos, **extra},
                    rc, caches=view)
                paging.merge_slot(caches, view, slot)
                return logits

            step = self._paged_step(chunk, {
                "tokens": ((1, bucket), torch.int32), **self._slot_inputs(),
                "hist": ((1,), torch.int32), "true_len": ((1,), torch.int32)})
            self.chunk_graphs[bucket] = step
        return step

    def _slot_inputs(self) -> Dict[str, Any]:
        return {"slot": ((1,), torch.int64),
                "bt_row": ((self.paging.blocks_per_slot,), torch.int32)}

    def _paged_step(self, fn, inputs) -> StepGraph:
        """Build a paged prefill step. Its warm-up runs over the zeroed
        static inputs: slot 0 and a true length of 0, so every arena
        write goes to the sink, but slot 0's ``len`` and its column of
        every pass-through leaf (the cross memories) are written;
        they are put back after the build."""
        slot0 = [t[:, 0] for t in (*self._len_leaves(),
                                   *paging.passthrough_leaves(self.caches))]
        saved = [t.clone() for t in slot0]
        step = StepGraph(fn, inputs, self.device, pool=self.prefill_pool)
        for t, s in zip(slot0, saved):
            t.copy_(s)
        return step

    def _len_leaves(self) -> List[torch.Tensor]:
        return [n["len"] for n in paging.attn_nodes(self.caches)]

    def _prefill_target(self, tr: TrackedRequest) -> int:
        """Positions to prefill before the request (re)joins decode: the
        prompt, and for a preempted request its generated tokens but the
        last (which becomes the resumed decode's input)."""
        if tr.preempted and tr.generated:
            return tr.prompt_len + len(tr.generated) - 1
        return tr.prompt_len

    def _prefill_tokens(self, tr: TrackedRequest) -> np.ndarray:
        seq = np.asarray(tr.request.prompt, np.int32)
        if tr.preempted and len(tr.generated) > 1:
            seq = np.concatenate([seq, np.asarray(tr.generated[:-1],
                                                  np.int32)])
        return seq

    def _prefill_extent(self, tr: TrackedRequest) -> Tuple[int, int, bool]:
        """(c, bucket, final) of the request's next prefill step: the
        positions it prefills (the whole target, or under chunked prefill
        its next ``prefill_chunk``), the length they run at, and whether
        they reach the target."""
        target = self._prefill_target(tr)
        chunked = self._chunked and target > self.ecfg.prefill_chunk
        pos0 = tr.prefill_pos
        c = (min(self.ecfg.prefill_chunk, target - pos0) if chunked
             else target)
        bucket = api.bucket_for(c, self._buckets) if self._bucketed else c
        return c, bucket, pos0 + c >= target

    def _prefill_one(self, slot: int, tr: TrackedRequest, c: int,
                     bucket: int, final: bool
                     ) -> Tuple[Optional[int], bool, bool]:
        """Advance the request in ``slot`` by one prefill step of ``c``
        positions at length ``bucket`` (``_prefill_extent``). Returns
        (token, bad, final): ``final`` False after a
        non-final chunk (the slot stays occupied but inactive); ``bad``
        when the sampled row holds a NaN/Inf (the slot is not activated);
        ``token`` the first sampled token on the final step, None for a
        chunk and for a preempted request's resume, whose decode state is
        restored from the preemption instead."""
        fp, tracer = self.fault_plan, self.tracer
        poison = 0.0
        if fp is not None:
            if fp.poll("prefill", self._tick, tr.uid) is not None:
                raise InjectedFault("prefill", self._tick, tr.uid)
            spec = fp.poll("poison", self._tick, tr.uid)
            if spec is not None:
                poison = float("nan") if spec.mode == "nan" else float("inf")
        req, sp = tr.request, tr.request.sampling
        target = self._prefill_target(tr)
        pos0 = tr.prefill_pos
        # edge-pad to the bucket: causally masked for the real rows
        chunk = np.pad(self._prefill_tokens(tr)[pos0:pos0 + c],
                       (0, bucket - c), mode="edge")[None]
        cache = None
        # the graph's outputs are consumed (sample, pad, insert) before
        # any other replay: all of it is ordered on one stream
        with torch.no_grad(), tracer.span("prefill.replay", device=True):
            if self.paging is None:
                logits, cache = self.prefill_graph(bucket)(tokens=chunk)
            elif pos0 == 0:
                logits = self.prefill_graph(bucket)(
                    tokens=chunk, slot=[slot], bt_row=self.tables[slot],
                    true_len=[c])
            else:
                logits = self.chunk_graph(bucket)(
                    tokens=chunk, slot=[slot], bt_row=self.tables[slot],
                    hist=[pos0], true_len=[c])
                self.metrics_counters.prefill_chunks += 1
            last = logits[0, c - 1, :self.model.cfg.vocab_size][None]
            if fp is not None:
                last = last + poison
            finite = torch.isfinite(last).all()
        with tracer.span("prefill.sync", wait=True):
            finite = bool(finite)
        if not finite:
            return None, True, final
        if cache is not None:
            with torch.no_grad(), tracer.span("prefill.insert", device=True):
                _insert_slot(self.caches, pad_prefill_cache(
                    cache, self.ecfg.max_len, window=self.window,
                    true_len=c), slot)
        tr.prefill_pos = pos0 + c
        if not final:
            return None, False, False

        stop = sorted(req.stop_set)
        self.positions[slot] = target
        self.temperature[slot] = sp.temperature
        self.top_k[slot] = sp.top_k
        self.top_p[slot] = sp.top_p
        self.greedy[slot] = sp.greedy
        self.stop_ids[slot, :] = -1
        self.stop_ids[slot, :len(stop)] = stop
        self.active[slot] = True
        self._tables_dirty = self.paging is not None
        gen = None
        if not sp.greedy:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(sp.seed)
        self.generators[slot] = gen
        if tr.preempted and tr.generated:
            # the resume: the stream goes on from the decode state saved
            # at preemption, as if never interrupted
            if gen is not None:
                gen.set_state(tr.resume_gen_state)
            self.last_token[slot] = tr.generated[-1]
            self.remaining[slot] = tr.resume_remaining
            tr.preempted = False
            self._prime_spec(slot, tr)
            return None, False, True
        with torch.no_grad(), tracer.span("prefill.sample", device=True):
            tok, lp = self._sample_row(last, slot)
        with tracer.span("prefill.sync", wait=True):
            tok = int(tok[0])
            lp = float(lp[0]) if sp.logprobs else None
        tr.generated.append(tok)
        if lp is not None:
            tr.logprobs.append(lp)
        self.last_token[slot] = tok
        # a paged full cache admits length-aware: the budget clamps to
        # the capacity left past the prompt (a ring wraps instead)
        budget = req.max_new_tokens
        if self.paging is not None and self.window == 0:
            budget = min(budget, self.ecfg.max_len - target + 1)
        self.remaining[slot] = budget - 1
        self._prime_spec(slot, tr)
        return tok, False, True

    def _prime_spec(self, slot: int, tr: TrackedRequest) -> None:
        """(Re)prime the slot's speculative state at activation: its
        opt-in flag and its successor row, from the whole token history
        (prompt and generated tokens, the one prefill just sampled
        included). The row is primed on the host, where repeated sources
        resolve in order, then copied to the device."""
        if not self.spec_k:
            return
        self.spec_on[slot] = bool(tr.request.speculate)
        row = np.empty((1, self.succ.shape[1]), np.int32)
        speculative.prime_successors(row, 0, np.concatenate(
            [tr.request.prompt, np.asarray(tr.generated, np.int32)]))
        self.succ[slot].copy_(torch.from_numpy(row[0]))

    def _prefill_step_events(self, slot: int,
                             events: List[StreamEvent]) -> bool:
        """One prefill step of ``slot`` and its events and counters:
        ``prefills`` counts a step that emits a first token or poisons; a
        non-final chunk counts in ``prefill_chunks`` only, and a good
        resume in neither (its token was counted before the preemption).
        Returns whether the step poisoned."""
        m = self.metrics_counters
        tr = self.sched.slots[slot]
        t0 = time.perf_counter()
        pos0 = tr.prefill_pos
        c, bucket, final = self._prefill_extent(tr)
        with self.tracer.span("engine.prefill", tr.uid, bucket=bucket,
                              true_len=c, chunk=pos0 > 0 or not final):
            tok, bad, final = self._prefill_one(slot, tr, c, bucket, final)
        dt = time.perf_counter() - t0
        tr.prefill_s += dt
        m.prefill_s += dt
        m.prefill_prompt_tokens += tr.prefill_pos - pos0
        m.prefill_bucket_tokens += bucket
        if bad:
            m.prefills += 1
            m.poisoned_slot_steps += 1
            events.append(StreamEvent(tr.uid, 0, None, "error"))
            self._finish_slot(slot, "error")
            return True
        if not final:
            return False
        tr.decode_t0 = time.perf_counter()
        if tok is None:  # a resume rejoins decode silently
            return False
        m.prefills += 1
        m.tokens_generated += 1
        reason = None
        if tok in tr.stop_set:
            reason = "stop"
        elif int(self.remaining[slot]) <= 0:
            reason = "length"
        lp = tr.logprobs[-1] if tr.request.sampling.logprobs else None
        events.append(StreamEvent(tr.uid, 0, tok, reason, logprob=lp))
        if reason is not None:
            self._finish_slot(slot, reason)
        return False

    # ------------------------------------------------------ paged KV blocks
    def _update_kv_gauges(self) -> None:
        m = self.metrics_counters
        used = self.pool.used_count
        m.blocks_in_use = used
        m.blocks_free = self.pool.free_count
        m.kv_bytes_in_use = used * self.paging.bytes_per_block
        m.peak_blocks_in_use = max(m.peak_blocks_in_use, used)
        m.peak_kv_bytes_in_use = max(m.peak_kv_bytes_in_use,
                                     m.kv_bytes_in_use)

    def _alloc_blocks(self, slot: int, n: int) -> bool:
        """Grow ``slot`` by ``n`` pool blocks, all or nothing."""
        if n <= 0:
            return True
        blks = self.pool.alloc(n)
        if blks is None:
            return False
        start = len(self._owned[slot])
        self._owned[slot].extend(blks)
        self.tables[slot, start:start + n] = blks
        self._tables_dirty = True
        self._update_kv_gauges()
        return True

    def _free_blocks(self, slot: int) -> None:
        """Give back every block ``slot`` owns; its table row goes to the
        sentinel."""
        if self._owned[slot]:
            self.pool.free(self._owned[slot])
            self._owned[slot] = []
        self.tables[slot, :] = self.paging.sentinel
        self._tables_dirty = True
        self._update_kv_gauges()

    def _sync_tables(self) -> None:
        """Write the host's tables into the cache before a decode step,
        the rows of slots that are not active (free, or mid-prefill: they
        own blocks but take no decode write) on the sentinel. In place:
        the decode graph reads the new table at its next replay."""
        if self.paging is None or not self._tables_dirty:
            return
        paging.set_block_tables(self.caches, np.where(
            self.active[:, None], self.tables, self.paging.sentinel))
        self._tables_dirty = False

    def _preempt_victim(self) -> Optional[int]:
        """The youngest (highest-uid) active slot whose resume prefill
        still fits ``max_len``; None when none does."""
        best = None
        for b in np.nonzero(self.active)[0]:
            tr = self.sched.slots[int(b)]
            if tr.prompt_len + max(0, len(tr.generated) - 1) > self.ecfg.max_len:
                continue
            if best is None or tr.uid > self.sched.slots[best].uid:
                best = int(b)
        return best

    def _preempt(self, slot: int) -> None:
        """Evict ``slot`` mid-decode: save its generator's state and its
        budget on the request, free its blocks and put it back at the
        head of the queue."""
        tr = self.sched.slots[slot]
        gen = self.generators[slot]
        tr.resume_gen_state = None if gen is None else gen.get_state()
        tr.resume_remaining = int(self.remaining[slot])
        tr.preempted = True
        tr.prefill_pos = 0
        self.active[slot] = False
        self.generators[slot] = None
        self.sched.slots[slot] = None
        self.sched.queue.appendleft(tr)
        self._free_blocks(slot)
        self.metrics_counters.preemptions += 1
        log.info("request %d preempted out of slot %d (out of KV blocks); "
                 "re-queued at the head with %d tokens generated",
                 tr.uid, slot, len(tr.generated))

    def _grow_decode_blocks(self) -> None:
        """Before a decode step, give every active slot the blocks its
        next write needs — and a speculating slot's K draft positions,
        up to max_len (draft rows past its blocks go to the sink); while
        the pool is empty, preempt the youngest request (possibly the
        one that needs the block)."""
        for b in np.nonzero(self.active)[0]:
            b = int(b)
            k_ahead = self.spec_k if self.spec_on[b] else 0
            while self.active[b]:
                need = self.paging.blocks_for(
                    min(int(self.positions[b]) + 1 + k_ahead,
                        self.ecfg.max_len))
                short = need - len(self._owned[b])
                if short <= 0 or self._alloc_blocks(b, short):
                    break
                victim = self._preempt_victim()
                if victim is None:
                    raise RuntimeError(
                        "out of KV blocks with no preemptible request; "
                        "raise EngineConfig.num_blocks")
                self._preempt(victim)

    # -------------------------------------------------------------- decode
    def _make_decode_graph(self) -> StepGraph:
        """The batched decode step, built (on CUDA: captured) once per
        engine, as the reference jits ``_decode_impl`` once, and again
        only after a ``backend`` fault: the model's decode over static
        (B, 1) tokens and positions and the engine's caches, which it
        updates in place, through the (B, vocab) fp32 logits. Under
        ``speculate_k`` it is ``speculative.verify_logits`` instead, over
        the same inputs and ``succ``: (B, K + 1, vocab) logits and the (B,
        K + 1) window. The build's warm-up writes rows and ``len`` into
        every slot of the caches (a paged cache: through its tables); the
        caller undoes that."""
        self.trace_counts["decode"] += 1
        model, params, caches = self.model, self.params, self.caches
        rc, vocab = self._rc_decode, self.model.cfg.vocab_size
        B = self.ecfg.num_slots
        succ, k = self.succ, self.spec_k

        def decode(tokens, positions):
            if k:
                return speculative.verify_logits(model, params, caches, succ,
                                                 tokens, positions, rc, k)
            logits, _ = model.decode(params, tokens, positions, caches, rc)
            return logits[:, 0, :vocab]

        return StepGraph(decode, {"tokens": ((B, 1), torch.int32),
                                  "positions": ((B, 1), torch.int32)},
                         self.device)

    def _fail_backend(self, name: Optional[str]) -> None:
        """A ``backend`` fault: quarantine ``name`` (None: the decode
        plan's backend) in the default planner, re-plan, and rebuild the
        decode graph over the live caches, whose every leaf (tables and
        ``len`` included) and the successor table come out of the build
        as they went in; the prefill and chunk graphs are dropped and
        rebuild at first use. The old graphs' memory is released before
        the new capture."""
        if name is None:
            name = self.plans["decode"][0][1].backend
        plan_mod.default_planner().record_backend_failure(name)
        self.metrics_counters.backend_fallbacks += 1
        log.warning("backend %r quarantined; re-planning and rebuilding the "
                    "decode graph", name)
        live = [t.clone() for t in tensor_leaves(self.caches)]
        succ = self.succ.clone() if self.succ is not None else None
        for g in (self.decode_graph, *self.prefill_graphs.values(),
                  *self.chunk_graphs.values()):
            g.release()
        self.decode_graph = None
        self.prefill_graphs.clear()
        self.chunk_graphs.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            self.prefill_pool = torch.cuda.graph_pool_handle()
        self.plans = self._preplan()
        self.decode_graph = self._make_decode_graph()
        for t, saved in zip(tensor_leaves(self.caches), live):
            t.copy_(saved)
        if succ is not None:
            self.succ.copy_(succ)

    def _decode(self, poison: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, ...]:
        """One decode step over every slot: the decode graph, then
        sampling and stopping on its logits (eager: per-slot generators;
        under ``speculate_k`` ``speculative.settle_window``), read back in
        one copy. ``poison`` (B,), when given, is added to each lane's
        logits first. Returns host arrays (tokens (B, S), logprobs (B,
        S), emitted counts e (B,), drafts accepted (B,), done, bad), S =
        K + 1; a token is emitted where its column is below e."""
        act, tracer = self.active, self.tracer
        with tracer.span("decode.graph", device=True):
            out = self.decode_graph(
                tokens=np.where(act, self.last_token, 0),
                positions=np.where(act, self.positions, 0))
        host = {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "stop_ids": self.stop_ids,
                "remaining": self.remaining, "active": act}
        if self.spec_k:
            host["spec_on"] = self.spec_on
        if poison is not None:
            host["poison"] = poison
        greedy = list(np.where(act, self.greedy, True))
        with torch.no_grad(), tracer.span("decode.epilogue", device=True):
            k = self._knobs.load(host)
            if poison is not None:
                p = k["poison"]
                out = (out + p[:, None] if not self.spec_k
                       else (out[0] + p[:, None, None], out[1]))
            if not self.spec_k:
                tok, done, bad = api.sample_and_stop(
                    out, generators=self.generators,
                    temperature=k["temperature"], top_k=k["top_k"],
                    top_p=k["top_p"], greedy=greedy, stop_ids=k["stop_ids"],
                    remaining=k["remaining"], active=k["active"])
                lp = api.token_logprobs(out, tok)
                e = (k["active"] & ~bad).to(torch.int32)
                cols = [tok[:, None], lp.view(torch.int32)[:, None]]
                accepted, states = torch.zeros_like(e), None
            else:
                logits, window = out
                toks, lps, e, accepted, done, bad, states = \
                    speculative.settle_window(
                        logits, window, self.caches, self.succ,
                        generators=self.generators,
                        temperature=k["temperature"], top_k=k["top_k"],
                        top_p=k["top_p"], greedy=greedy,
                        stop_ids=k["stop_ids"], remaining=k["remaining"],
                        active=k["active"], spec_on=k["spec_on"])
                cols = [toks, lps.view(torch.int32)]
            packed = torch.cat(cols + [torch.stack(
                [e, accepted, done.to(torch.int32), bad.to(torch.int32)],
                dim=1)], dim=1)
        with tracer.span("decode.readback", wait=True):
            packed = packed.cpu().numpy()
        S = self.spec_k + 1
        e = packed[:, 2 * S]
        if states is not None:
            speculative.rollback_generators(self.generators, states, e)
        return (packed[:, :S], packed[:, S:2 * S].view(np.float32), e,
                packed[:, 2 * S + 1], packed[:, 2 * S + 2].astype(bool),
                packed[:, 2 * S + 3].astype(bool))

    def _timeout_sweep(self) -> List[StreamEvent]:
        """Finish requests past their ``deadline_s`` (queued ones also past
        ``queue_ttl_s``): queued ones before they waste a prefill, active
        ones before another decode step."""
        events: List[StreamEvent] = []
        now = time.perf_counter()
        ttl = self.ecfg.queue_ttl_s

        def dead_in_queue(tr: TrackedRequest) -> bool:
            return tr.expired(now) or (ttl is not None
                                       and now - tr.submit_t > ttl)

        for tr in self.sched.prune_queue(dead_in_queue):
            self.metrics_counters.count_finish("timeout")
            # a preempted request waiting to resume holds streamed tokens
            self._outputs[tr.uid] = RequestOutput(
                uid=tr.uid, tokens=tuple(tr.generated),
                logprobs=tuple(tr.logprobs), finish_reason="timeout",
                queue_wait_s=now - tr.submit_t)
            events.append(StreamEvent(tr.uid, -1, None, "timeout"))
            self._retain(tr.uid)
        for b in list(self.sched.active_slots()):
            tr = self.sched.slots[b]
            if tr.expired(now):
                events.append(
                    StreamEvent(tr.uid, len(tr.generated), None, "timeout"))
                self._finish_slot(b, "timeout")
        return events

    def step(self) -> List[StreamEvent]:
        """One tick: deadline sweep, the next chunk of every mid-prefill
        slot, admit + prefill queued requests (a paged engine reserving
        each one's blocks), blocks for every active slot's next write
        (preempting when the pool is empty), one batched decode step over
        the active slots, retire finished requests (in the step their
        stop condition is met). Returns the tick's StreamEvents.

        Faults, as the reference's: a poisoned lane finishes "error" and
        the rest of the batch streams on; ``breaker_k`` poisoned ticks in
        a row trip the breaker, which rejects the queue; a ``backend``
        fault re-plans (``_fail_backend``). An exception out of ``step()``
        (a scripted prefill, decode or sample fault, or a real one) leaves
        the tick's events undelivered: a snapshot restore is the
        recovery."""
        with self.tracer.span("engine.step", tick=self._tick) as span:
            events = self._step()
            span.set(events=len(events))
        return events

    def _step(self) -> List[StreamEvent]:
        m, tracer = self.metrics_counters, self.tracer
        tick, fp = self._tick, self.fault_plan
        events: List[StreamEvent] = list(self._pending)
        self._pending.clear()
        with tracer.span("engine.sweep"):
            events.extend(self._timeout_sweep())

        if fp is not None:
            spec = fp.poll("backend", tick)
            if spec is not None:
                self._fail_backend(spec.backend)

        poisoned = did_work = False
        # occupied but not active: a chunked prefill in progress
        for slot in self.sched.active_slots():
            if not self.active[slot]:
                did_work = True
                poisoned |= self._prefill_step_events(slot, events)

        planned_free = self.pool.free_count if self.paging is not None else 0

        def can_admit(tr: TrackedRequest) -> bool:
            nonlocal planned_free
            need = self.paging.blocks_for(self._prefill_target(tr))
            if need > planned_free:
                return False
            planned_free -= need
            return True

        for slot in self.sched.admit(can_admit if self.paging else None):
            tr = self.sched.slots[slot]
            tr.queue_wait_s = time.perf_counter() - tr.submit_t
            with tracer.span("engine.admit", tr.uid,
                             queue_wait=tr.queue_wait_s):
                m.admitted += 1
                m.queue_wait_s += tr.queue_wait_s
                if self.paging is not None:
                    ok = self._alloc_blocks(
                        slot, self.paging.blocks_for(self._prefill_target(tr)))
                    assert ok, ("can_admit reserved blocks the pool cannot "
                                "supply")
            did_work = True
            poisoned |= self._prefill_step_events(slot, events)

        if self.paging is not None and self.active.any():
            self._grow_decode_blocks()

        active_idx = np.nonzero(self.active)[0]
        if active_idx.size:
            did_work = True
            with tracer.span("engine.decode", lanes=int(active_idx.size)):
                poisoned |= self._decode_step_events(active_idx, events)

        if did_work:
            was_tripped = self.breaker.tripped
            if self.breaker.record(poisoned) and not was_tripped:
                events.extend(self._reject_pending_unhealthy())

        with tracer.span("engine.deliver"):
            for ev in events:
                buf = self._buffers.get(ev.uid)
                if buf is not None:
                    buf.append(ev)
        self._tick += 1
        return events

    def _decode_step_events(self, active_idx: np.ndarray,
                            events: List[StreamEvent]) -> bool:
        """The decode step of the tick over the active slots
        ``active_idx``: the step, its counters and its events (finishing
        the slots whose stop condition it met). Returns whether a lane
        poisoned."""
        m, tick, fp = self.metrics_counters, self._tick, self.fault_plan
        self._sync_tables()
        poison = None
        if fp is not None:
            if fp.poll("decode", tick) is not None:
                raise InjectedFault("decode", tick)
            poison = np.zeros((self.ecfg.num_slots,), np.float32)
            for b in active_idx:
                spec = fp.poll("poison", tick, self.sched.slots[b].uid)
                if spec is not None:
                    poison[b] = np.nan if spec.mode == "nan" else np.inf
        t0 = time.perf_counter()
        self.watchdog.start_step()
        toks, lps, e_cnt, acc, done, bad = self._decode(poison)
        if self.watchdog.end_step().is_straggler:
            m.straggler_steps += 1
        if fp is not None and fp.poll("sample", tick) is not None:
            # the device stepped, the host did not: a torn state
            raise InjectedFault("sample", tick)
        with self.tracer.span("decode.events"):
            n_bad = int(np.count_nonzero(bad))
            n_emit = int(e_cnt.sum())
            m.decode_steps += 1
            m.decode_slot_steps += int(active_idx.size)
            m.decode_s += time.perf_counter() - t0
            m.tokens_generated += n_emit
            m.extra_decode_tokens += n_emit - (int(active_idx.size) - n_bad)
            m.poisoned_slot_steps += n_bad
            if self.spec_k:
                lanes = self.active & ~bad & self.spec_on
                n_spec = int(np.count_nonzero(lanes))
                n_acc = int(acc[lanes].sum())
                m.drafted_tokens += self.spec_k * n_spec
                m.accepted_draft_tokens += n_acc
                m.rejected_draft_tokens += self.spec_k * n_spec - n_acc
            # e_cnt: the tokens each lane emitted (0 for free and bad
            # lanes, 1 without speculation)
            self.positions += e_cnt
            self.remaining -= e_cnt
            last = toks[np.arange(toks.shape[0]), np.maximum(e_cnt - 1, 0)]
            self.last_token = np.where(e_cnt > 0, last, self.last_token)
            for b in active_idx:
                b = int(b)
                tr = self.sched.slots[b]
                if bad[b]:
                    events.append(StreamEvent(tr.uid, len(tr.generated),
                                              None, "error"))
                    self._finish_slot(b, "error")
                    continue
                n = int(e_cnt[b])
                reason = None
                if done[b]:
                    reason = ("stop" if int(toks[b, n - 1]) in tr.stop_set
                              else "length")
                want_lp = tr.request.sampling.logprobs
                for j in range(n):
                    t = int(toks[b, j])
                    lpj = None
                    if want_lp:
                        lpj = float(lps[b, j])
                        tr.logprobs.append(lpj)
                    events.append(StreamEvent(
                        tr.uid, len(tr.generated), t,
                        reason if j == n - 1 else None, logprob=lpj))
                    tr.generated.append(t)
                if reason is not None:
                    self._finish_slot(b, reason)
        return n_bad > 0

    def _reject_pending_unhealthy(self) -> List[StreamEvent]:
        """The breaker just tripped: reject every queued request (the
        slots in flight drain)."""
        events: List[StreamEvent] = []
        for tr in self.sched.drain_queue():
            self.metrics_counters.rejected += 1
            log.error("request %d rejected: engine unhealthy (circuit "
                      "breaker tripped)", tr.uid)
            self._outputs[tr.uid] = RequestOutput(
                uid=tr.uid, tokens=(), finish_reason="rejected")
            events.append(StreamEvent(tr.uid, -1, None, "rejected"))
            self._retain(tr.uid)
        return events

    def _finish_slot(self, slot: int, reason: str) -> TrackedRequest:
        tr = self.sched.finish(slot)
        self.active[slot] = False
        self.generators[slot] = None
        if self.paging is not None:
            self._free_blocks(slot)
        # in flight across a restore: the reason says so (the tokens are
        # the uninterrupted stream's)
        if tr.restored and reason in ("stop", "length"):
            reason = f"{reason}-after-restore"
        self.metrics_counters.count_finish(reason)
        decode_s = (time.perf_counter() - tr.decode_t0
                    if len(tr.generated) > 1 else 0.0)
        self._outputs[tr.uid] = RequestOutput(
            uid=tr.uid, tokens=tuple(tr.generated),
            logprobs=tuple(tr.logprobs), finish_reason=reason,
            queue_wait_s=tr.queue_wait_s, prefill_s=tr.prefill_s,
            decode_s=decode_s)
        self._retain(tr.uid)
        return tr

    # ------------------------------------------------------------ streaming
    @property
    def idle(self) -> bool:
        return self.sched.idle and not self._pending

    @property
    def healthy(self) -> bool:
        """False once the circuit breaker tripped."""
        return not self.breaker.tripped

    def output(self, uid: int) -> Optional[RequestOutput]:
        """The terminal RequestOutput once ``uid`` finished (else None)."""
        return self._outputs.get(uid)

    def evicted(self, uid: int) -> bool:
        """True when ``uid`` was handed out and its output and events were
        evicted past ``max_retained`` (not when it never was)."""
        if not 1 <= uid <= self.sched.last_uid:
            return False
        if uid in self._outputs or uid in self._buffers:
            return False
        return not any(tr is not None and tr.uid == uid
                       for tr in (*self.sched.queue, *self.sched.slots))

    def stream(self, uid: int) -> Iterator[StreamEvent]:
        """Yield ``uid``'s events, stepping the engine as needed; ends
        after the terminal event. RequestEvicted (a KeyError) when its
        events were evicted past ``max_retained``, KeyError when it was
        never handed out or is drained; RuntimeError when ``stream_stall_s``
        passes without an event for it."""
        buf = self._buffers.get(uid)
        if buf is None:
            if self.evicted(uid):
                raise RequestEvicted(
                    f"request {uid} was served but its events were evicted "
                    f"past max_retained={self.ecfg.max_retained}; stream "
                    "promptly or raise EngineConfig.max_retained")
            if 1 <= uid <= self.sched.last_uid:
                raise KeyError(f"request {uid} already streamed to completion")
            raise KeyError(f"unknown request uid {uid}")
        t_last = time.perf_counter()
        while True:
            while buf:
                ev = buf.popleft()
                t_last = time.perf_counter()
                yield ev
                if ev.done:
                    self._buffers.pop(uid, None)
                    return
            if self.idle:
                raise RuntimeError(
                    f"engine idle but request {uid} never finished")
            self.step()
            if not buf and (time.perf_counter() - t_last
                            > self.ecfg.stream_stall_s):
                raise RuntimeError(
                    f"stream({uid}) stalled: no event for "
                    f"{self.ecfg.stream_stall_s:.1f}s "
                    f"(EngineConfig.stream_stall_s)")

    # ----------------------------------------------------- snapshot/restore
    _SLOT_STATE = ("positions", "last_token", "temperature", "top_k",
                   "top_p", "greedy", "stop_ids", "remaining", "active")

    def snapshot(self) -> EngineSnapshot:
        """The whole engine state, copied to the host: every cache leaf,
        the slot state, each slot's generator state, under ``speculate_k``
        the successor table and opt-in flags (path-flattened in the
        checkpoint format), the paging state, the scheduler, the outputs,
        the undrained events, the metrics, the breaker and the tick.
        Nothing in it aliases the engine."""
        m = self.metrics_counters
        m.snapshots += 1
        slots: Dict[str, Any] = {n: getattr(self, n) for n in self._SLOT_STATE}
        slots["generator"] = [None if g is None else g.get_state()
                              for g in self.generators]
        if self.spec_k:
            slots["succ"], slots["spec_on"] = self.succ, self.spec_on
        flat = ckpt_manager.flatten_with_paths({"caches": self.caches,
                                                "slots": slots})
        arrays = {path: (ckpt_manager.to_host(leaf)   # a copy on the host
                         if isinstance(leaf, torch.Tensor)
                         else None if leaf is None else np.array(leaf))
                  for path, leaf in flat}
        return EngineSnapshot(
            tick=self._tick, arrays=arrays, uid_counter=self.sched.last_uid,
            queue=[tr.clone() for tr in self.sched.queue],
            slots=[tr.clone() if tr is not None else None
                   for tr in self.sched.slots],
            outputs=dict(self._outputs),        # RequestOutput is frozen
            buffers={uid: list(b) for uid, b in self._buffers.items()},
            pending=list(self._pending),        # StreamEvent is frozen
            retired=list(self._retired), metrics=m.state(),
            breaker=self.breaker.state(), num_slots=self.ecfg.num_slots,
            max_len=self.ecfg.max_len, paged=self.paging is not None,
            block_size=self.paging.block_size if self.paging else 0,
            num_blocks=self.paging.num_blocks if self.paging else 0,
            **(paging.paged_state(self.tables, self.pool, self._owned)
               if self.paging is not None else {}))

    def restore(self, snap: EngineSnapshot) -> None:
        """Adopt a snapshot: the engine resumes at its tick, and the
        requests in flight go on with the streams the snapshotted engine
        would have given (they finish "...-after-restore"). The graphs
        read the caches, ``succ`` and the block tables at fixed
        addresses, so every one of them is written in place: no tensor
        the engine holds is replaced. ValueError when the snapshot's
        geometry is not the engine's."""
        if (snap.num_slots != self.ecfg.num_slots
                or snap.max_len != self.ecfg.max_len):
            raise ValueError(
                f"snapshot geometry (slots={snap.num_slots}, "
                f"max_len={snap.max_len}) does not match engine "
                f"(slots={self.ecfg.num_slots}, max_len={self.ecfg.max_len})")
        if snap.paged != (self.paging is not None):
            raise ValueError(
                f"snapshot paged={snap.paged} does not match engine "
                f"paged={self.paging is not None}")
        if self.paging is not None and (
                snap.block_size != self.paging.block_size
                or snap.num_blocks != self.paging.num_blocks):
            raise ValueError(
                f"snapshot paging geometry (block_size={snap.block_size}, "
                f"num_blocks={snap.num_blocks}) does not match engine "
                f"(block_size={self.paging.block_size}, "
                f"num_blocks={self.paging.num_blocks})")
        live = dict(ckpt_manager.flatten_with_paths({"caches": self.caches}))
        saved = {p: a for p, a in snap.arrays.items()
                 if p.startswith("/caches/")}
        if set(saved) != set(live):
            raise ValueError(
                f"snapshot cache has {len(saved)} leaves, engine cache has "
                f"{len(live)}: incompatible model or cache geometry")
        for path, leaf in live.items():
            src = ckpt_manager.from_host(saved[path])
            if tuple(src.shape) != tuple(leaf.shape) or src.dtype != leaf.dtype:
                raise ValueError(
                    f"snapshot cache leaf {path} is {src.dtype} "
                    f"{tuple(src.shape)}, the engine's {leaf.dtype} "
                    f"{tuple(leaf.shape)}: incompatible cache geometry")
            leaf.copy_(src)
        slots = ckpt_manager.unflatten_from_paths(
            {p[len("/slots"):]: a for p, a in snap.arrays.items()
             if p.startswith("/slots/")})
        for name in self._SLOT_STATE:
            setattr(self, name, np.array(slots[name],
                                         dtype=getattr(self, name).dtype))
        for b, st in enumerate(slots["generator"]):
            gen = None
            if st is not None:
                gen = torch.Generator(device=self.device)
                gen.set_state(torch.from_numpy(np.array(st, np.uint8)))
            self.generators[b] = gen
        if self.spec_k:
            self.succ.copy_(torch.from_numpy(np.asarray(slots["succ"])))
            self.spec_on = np.array(slots["spec_on"], bool)
        if self.paging is not None:
            self.tables[...] = snap.block_tables
            self.pool.restore(snap.pool_free)
            self._owned = [list(o) for o in snap.owned]
            self._tables_dirty = True
            self._update_kv_gauges()
        self.sched.restore_state(snap.uid_counter, snap.queue, snap.slots)
        for tr in self.sched.slots:
            if tr is not None:
                tr.restored = True
        self._outputs = dict(snap.outputs)
        self._buffers = {uid: deque(b) for uid, b in snap.buffers.items()}
        self._pending = list(snap.pending)
        self._retired = deque(snap.retired)
        self.metrics_counters.restore(dict(snap.metrics))
        self.metrics_counters.restores += 1
        self.breaker.restore(snap.breaker)
        self._tick = snap.tick

    def metrics(self) -> Dict[str, float]:
        return self.metrics_counters.snapshot()

    def generate(self, prompts: Sequence[np.ndarray], max_new_tokens: int,
                 sampling: Optional[SamplingParams] = None
                 ) -> Dict[int, List[int]]:
        """Serve a batch of prompts to completion: {uid: tokens} in
        submission order (greedy by default). Unservable prompts raise
        before anything is queued."""
        sampling = sampling or api.GREEDY
        reqs = [GenerationRequest(prompt=p, max_new_tokens=max_new_tokens,
                                  sampling=sampling) for p in prompts]
        bad = {i: why for i, r in enumerate(reqs)
               if (why := self._admission_error(r)) is not None}
        if bad:
            raise ValueError(f"generate(): unservable prompt(s) {bad}")
        uids = []
        for r in reqs:
            while len(self.sched.queue) >= self.sched.max_queue:
                self.step()
            uids.append(self.submit(r))
        while not self.idle:
            self.step()
        results: Dict[int, List[int]] = {}
        for uid in uids:
            results[uid] = list(self._outputs[uid].tokens)
            self._buffers.pop(uid, None)
        return results
