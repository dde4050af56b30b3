"""Plan-once / execute-many dispatch for every model-layer matmul (the
subset of ``repro/core/plan.py`` the serving path needs).

  LinearSpec : frozen, hashable shape + weight-kind signature of one
               matmul site, derived from ``(x, param node)``; the
               KV-VQ decode-attention site is matmul-shaped too
               (``kvq_attention_spec``).
  PlanPolicy : frozen, validated execution policy (vq_mode, impl,
               int8_prefill, and the plain EVA epilogue and block_v).
  MatmulPlan : the chosen backend, its resolved config and cost estimate,
               the predicted time that ranked it, and the ``run``
               callable.
  Planner    : LRU cache (LinearSpec, PlanPolicy) -> MatmulPlan; the same
               pair returns the SAME plan object.

Backends by weight kind (``fp`` and ``int8_torch`` register here, the
others from the kernel wrappers and ``core/logits_vq.py``, the modules of
``_BACKEND_MODULES``, imported lazily on the first plan):

  dense    : ``fp`` (``torch.matmul``) on any impl;
  int8     : ``int8_torch`` | ``int8_cuda`` (kernel B6) — dense prefill
             matmuls under ``int8_prefill``;
  vq       : in decode under ``impl="cuda"``, ``eva_fused`` (B1) or
             ``eva_split`` (B4 ``vq_gemm`` then B5 ``oc_lookup``); under
             ``impl="torch"`` the one of ``eva_direct`` | ``eva_flat`` |
             ``eva_blocked`` | ``eva_recon`` (``core/ops.py``'s plain
             epilogues, registered here) that ``select_epilogue`` or the
             policy's ``epilogue`` names, as the reference's jnp backends;
             ``dequant`` (B3) elsewhere;
  kvq_attn : ``kvq_dequant_torch`` | ``kvq_flash_cuda`` (B7) — decode
             attention over a vector-quantized KV cache;
  vq_logits: ``vql_gather_torch`` | ``vql_dequant_torch`` on any impl —
             the VQ-Logits LM head (plain torch, as the reference's jnp).

``impl="cuda"`` runs the hand-written kernels (their wrappers take the
plain version only for tensors on the CPU); ``impl="torch"`` runs the
plain PyTorch formulations on any device — the reference a run on the
card is compared with.

Selection is COST-RANKED, as in the reference: the planner builds every
backend whose matcher accepts (spec, policy), prices each candidate's
``PlanCost`` through the per-backend time model of ``core/calibrate.py``
(constants fitted on the card when a calibration is loaded, the shared
analytic rates otherwise) and picks the cheapest; registration order
breaks exact ties. Today the genuine choice is a decode VQ site under
``impl="cuda"``, where ``eva_fused`` and ``eva_split`` both match;
analytically the fused kernel wins.

Backend quarantine, as in the reference: ``record_backend_failure``
takes a backend out of the ranking for ``cooloff_s`` (30 s by default)
and clears the plan cache, so every site re-ranks on the backends left;
the cool-off's expiry releases it. The engine's scripted ``backend``
fault calls it (``serve/engine.py``); ``reset_quarantine`` clears the
default planner's.

Three deliberate divergences from the reference:

  * No degrade to the plain formulation. When every matched backend is
    quarantined, the reference first degrades to ``impl="jnp"``; on the
    card that would be the plain PyTorch version, a hidden fallback. Here
    an ``eva`` policy degrades straight to ``vq_mode="dequant"`` under
    the SAME impl (under ``impl="cuda"`` the dequant-GEMV kernel, B3),
    and when that is quarantined too the quarantine is ignored and the
    kernels re-ranked, the reference's last resort. A plan under
    ``impl="cuda"`` never runs a plain version.
  * No execute-time fallback chain (the reference's ``_chain_run``): a
    backend's exception is never caught, and a kernel that fails on the
    card raises through the engine's step. Only an explicit
    ``record_backend_failure`` quarantines a backend;
    ``backend_stats`` therefore has no ``exec_fallbacks``.
  * The ``kvq_attn`` kind stays split by impl, where the reference lets
    ``kvq_dequant_jnp`` match every impl and ranks it against the kernel:
    a plain version is never a ranking candidate on the card. (The
    reference's ``int8_jnp`` matches only ``impl == "jnp"``, as the
    port's plain ``int8`` backend matches only ``impl == "torch"``.)
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import calibrate as calibrate_mod
from repro_torch.core import ops
from repro_torch.core.ops import EPILOGUES
from repro_torch.core.vq import VQWeight

log = logging.getLogger(__name__)

WEIGHT_KINDS = ("dense", "int8", "vq", "kvq_attn", "vq_logits")
VQ_MODES = ("none", "eva", "dequant")
IMPLS = ("cuda", "torch")

# a quarantined backend is ranked again after this cool-off: a transient
# failure recovers, a lasting one is quarantined again at its next fault
DEFAULT_BACKEND_COOLOFF_S = 30.0


def dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Shape + weight-kind signature of one matmul site. ``kind`` is the
    resolved weight kind: "dense", "int8" (a dense weight run through the
    INT8 prefill GEMM), "vq", "kvq_attn" (see ``kvq_attention_spec``) or
    "vq_logits" (``core.logits_vq.vq_logits_spec``: k is the head's
    codebook size). The VQ geometry fields are zero for dense and int8
    sites."""

    M: int
    K: int
    N: int
    kind: str
    x_dtype: str
    out_dtype: str
    C: int = 0
    V: int = 0
    k: int = 0                     # 2^n centroids per codebook
    d: int = 0
    splits: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in WEIGHT_KINDS:
            raise ValueError(
                f"unknown weight kind {self.kind!r}; expected one of {WEIGHT_KINDS}")

    @classmethod
    def for_vq(cls, vq: VQWeight, *, M: int, x_dtype: torch.dtype,
               out_dtype: torch.dtype) -> "LinearSpec":
        return cls(M=int(M), K=vq.K, N=vq.N, kind="vq",
                   x_dtype=dtype_name(x_dtype),
                   out_dtype=dtype_name(out_dtype), C=vq.C, V=vq.V,
                   k=int(vq.codebooks.shape[-1]), d=vq.d,
                   splits=tuple(vq.splits))

    @classmethod
    def for_dense(cls, w: torch.Tensor, *, M: int, x_dtype: torch.dtype,
                  out_dtype: torch.dtype, kind: str = "dense"
                  ) -> "LinearSpec":
        """Spec for a dense (.., K, N) weight; ``kind`` may be "int8" for
        the INT8 prefill GEMM path (ValueError on an unknown kind)."""
        return cls(M=int(M), K=int(w.shape[-2]), N=int(w.shape[-1]),
                   kind=kind, x_dtype=dtype_name(x_dtype),
                   out_dtype=dtype_name(out_dtype))


@dataclasses.dataclass(frozen=True)
class PlanPolicy:
    """Execution policy for one matmul.

    ``vq_mode`` : "eva" | "dequant" | "none" ("none" resolves by run mode:
                  EVA in decode, the dequant baseline elsewhere).
    ``impl``    : "cuda" (the hand-written kernels) | "torch" (the plain
                  PyTorch formulations).
    ``int8_prefill`` : route dense prefill matmuls through the INT8 GEMM.
    ``epilogue`` : "auto" or one of ``core/ops.EPILOGUES``; only the
                  plain EVA backends (``impl="torch"``) read it, and
                  ``impl="cuda"`` accepts only "auto".
    ``block_v``  : None (auto-sized) or a pinned v-block height of the
                  v-blocked epilogues ("blocked", "recon") under
                  ``impl="torch"``; the kernels size their own tiles.

    Statically contradictory combinations raise ValueError here, with
    the reference's messages.
    """

    vq_mode: str = "none"
    impl: str = "cuda"
    int8_prefill: bool = False
    epilogue: str = "auto"
    block_v: Optional[int] = None

    def __post_init__(self):
        if self.vq_mode not in VQ_MODES:
            raise ValueError(
                f"unknown vq_mode {self.vq_mode!r}; expected one of {VQ_MODES}")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; expected one of {IMPLS}")
        if self.epilogue not in EPILOGUES + ("auto",):
            raise ValueError(
                f"unknown epilogue {self.epilogue!r}; expected 'auto' or one "
                f"of {EPILOGUES}")
        if self.block_v is not None:
            if isinstance(self.block_v, bool) or not isinstance(self.block_v,
                                                                int):
                raise ValueError(f"block_v must be None ('auto') or an int, "
                                 f"got {self.block_v!r}")
            if self.block_v <= 0:
                raise ValueError(
                    f"block_v must be positive, got {self.block_v}")
            if self.impl == "torch" and self.vq_mode != "dequant" \
                    and self.epilogue not in ("blocked", "recon"):
                raise ValueError(
                    f"explicit block_v={self.block_v} conflicts with "
                    f"epilogue={self.epilogue!r}; block_v only applies to the "
                    "v-blocked epilogues ('blocked', 'recon') on "
                    "impl='torch'")

    def resolve_vq_mode(self, mode: str) -> "PlanPolicy":
        """Resolve vq_mode="none" by run mode (decode -> EVA, else the
        dequant baseline)."""
        if self.vq_mode != "none":
            return self
        return dataclasses.replace(
            self, vq_mode="eva" if mode == "decode" else "dequant")


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Analytic estimates for ranking: multiply-accumulates, add-only
    lookup or reconstruction work, per-call weight bytes, the extra
    device-memory round trip of multi-kernel formulations (the split
    backend's (C, M, V, 2^n) output codebook; 0 for single-kernel
    paths) and kernel launches per call."""

    macs: int
    lookup_adds: int
    weight_bytes: int
    intermediate_bytes: int = 0
    launches: int = 1


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """A frozen, executable matmul choice. ``predicted_us``,
    ``provenance`` and ``ranking`` record how the Planner ranked this
    backend against the other eligible candidates ("analytic" constants
    or a fitted "eva-calibration/v1" entry)."""

    backend: str
    spec: LinearSpec
    policy: PlanPolicy
    config: Tuple[Tuple[str, Any], ...]
    cost: PlanCost
    run: Callable[[Any, Any], Any]
    predicted_us: Optional[float] = None
    provenance: str = "analytic"
    ranking: Tuple[Tuple[str, float], ...] = ()

    def execute(self, x, leaf):
        """Run the planned matmul on ``leaf`` (a VQWeight or dense w)."""
        return self.run(x, leaf)

    @property
    def config_dict(self) -> Dict[str, Any]:
        return dict(self.config)

    def describe(self) -> str:
        """One line: backend, shape, resolved config and the ranked
        prediction (``pred=..us(analytic|eva-calibration/v1)``)."""
        s = self.spec
        parts = [self.backend, f"M={s.M}", f"K={s.K}", f"N={s.N}"]
        if s.splits:
            parts.append(f"splits={len(s.splits)}")
        parts += [f"{k}={v}" for k, v in self.config]
        if self.predicted_us is not None:
            parts.append(f"pred={self.predicted_us:.0f}us({self.provenance})")
        return " ".join(parts)

    def describe_ranking(self) -> str:
        """The ranked candidates, cheapest first ('' when only one
        backend was eligible)."""
        if len(self.ranking) < 2:
            return ""
        return " < ".join(f"{b}={us:.0f}us" for b, us in self.ranking)


def kvq_attention_spec(*, B: int, S: int, H: int, Hk: int, hd: int,
                       idx_width: int, entries: int, x_dtype: torch.dtype,
                       out_dtype: torch.dtype) -> LinearSpec:
    """Spec of a KV-VQ decode-attention site (kind="kvq_attn"), mapped
    onto the matmul fields as in the reference: M=batch, K=cache length
    S, N=H*hd, C=Hk, V=idx_width (uint8 indices per token and head),
    k=entries (codebook rows), d=hd."""
    return LinearSpec(M=int(B), K=int(S), N=int(H * hd), kind="kvq_attn",
                      x_dtype=dtype_name(x_dtype),
                      out_dtype=dtype_name(out_dtype), C=int(Hk),
                      V=int(idx_width), k=int(entries), d=int(hd))


def vq_weight_bytes(spec: LinearSpec) -> int:
    """Compressed per-call weight traffic of a VQ leaf."""
    idx = spec.C * spec.V * spec.N * (1 if spec.k <= 256 else 4)
    return idx + spec.C * spec.d * spec.k * 4 + spec.N * 4


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Backend:
    name: str
    matcher: Callable[[LinearSpec, PlanPolicy], bool]
    planner_fn: Callable[[LinearSpec, PlanPolicy], MatmulPlan]


_REGISTRY: "collections.OrderedDict[str, _Backend]" = collections.OrderedDict()
_REGISTRY_LOCK = threading.Lock()
# registration order breaks ranking ties, as in the reference: the fused
# kernel's module comes before the split pair's. They import this module,
# so it imports them only when a plan is first made
_BACKEND_MODULES = (
    "repro_torch.kernels.fused_vq_matmul.ops",
    "repro_torch.kernels.oc_lookup.ops",
    "repro_torch.kernels.dequant_gemv.ops",
    "repro_torch.kernels.int8_gemm.ops",
    "repro_torch.kernels.flash_decode.ops",
    "repro_torch.core.logits_vq",
)


def register_backend(name: str,
                     matcher: Callable[[LinearSpec, PlanPolicy], bool],
                     planner_fn: Callable[[LinearSpec, PlanPolicy], MatmulPlan],
                     ) -> None:
    """Register (or idempotently re-register) a matmul backend. Every
    backend whose matcher accepts a (spec, policy) pair is a ranking
    candidate; registration order breaks exact ties."""
    with _REGISTRY_LOCK:
        _REGISTRY[name] = _Backend(name, matcher, planner_fn)


def registered_backends() -> Tuple[str, ...]:
    for mod in _BACKEND_MODULES:
        importlib.import_module(mod)
    return tuple(_REGISTRY)


CacheInfo = collections.namedtuple("CacheInfo", "hits misses currsize maxsize")


class Planner:
    """LRU-cached, cost-ranked (LinearSpec, PlanPolicy) -> MatmulPlan
    resolver.

    ``calibration="default"`` loads the port's calibration file
    (``calibrate.load_default_calibration``: $EVA_TORCH_CALIBRATION, else
    ./CALIBRATION_TORCH.json; analytic when absent); None ranks
    analytically; a ``Calibration`` is used as given.
    ``reload_calibration`` swaps the model for FUTURE planning without
    touching cached plans; ``cache_clear`` re-ranks every site. A
    backend given to ``record_backend_failure`` is skipped by ranking for
    ``cooloff_s`` seconds (module docstring)."""

    def __init__(self, maxsize: int = 1024, calibration: Any = "default",
                 cooloff_s: float = DEFAULT_BACKEND_COOLOFF_S):
        self._cache: "collections.OrderedDict[Tuple[LinearSpec, PlanPolicy], MatmulPlan]" = (
            collections.OrderedDict())
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._calibration: Optional[calibrate_mod.Calibration] = None
        self.reload_calibration(calibration)
        # backend name -> monotonic expiry of its quarantine
        self.cooloff_s = cooloff_s
        self._quarantine: Dict[str, float] = {}
        self._backend_failures: Dict[str, int] = collections.Counter()

    # ---- backend quarantine
    def record_backend_failure(self, backend: str,
                               cooloff_s: Optional[float] = None) -> None:
        """Quarantine ``backend`` for ``cooloff_s`` (the planner's when
        None) and clear the plan cache, so planned sites re-rank too."""
        cool = self.cooloff_s if cooloff_s is None else cooloff_s
        with self._lock:
            self._backend_failures[backend] += 1
            self._quarantine[backend] = time.monotonic() + cool
            self._cache.clear()
        log.warning("backend %r quarantined for %.1fs (%d failures so far)",
                    backend, cool, self._backend_failures[backend])

    def _active_quarantine(self) -> Tuple[str, ...]:
        """The quarantined backends; expired ones are released here, and
        the cache cleared so a released backend is ranked again."""
        now = time.monotonic()
        with self._lock:
            expired = [b for b, t in self._quarantine.items() if now >= t]
            for b in expired:
                del self._quarantine[b]
            if expired:
                self._cache.clear()
            active = tuple(self._quarantine)
        for b in expired:
            log.info("backend %r released from quarantine", b)
        return active

    def reset_quarantine(self) -> None:
        """Forget every quarantine and failure count and clear the plan
        cache (the default planner is process-global: a test that
        quarantines must reset it)."""
        with self._lock:
            self._quarantine.clear()
            self._backend_failures.clear()
            self._cache.clear()

    def backend_stats(self) -> Dict[str, Any]:
        """Failures per backend and the quarantined set."""
        with self._lock:
            failures = dict(self._backend_failures)
        return {"failures": failures, "quarantined": self._active_quarantine()}

    @property
    def calibration(self) -> Optional[calibrate_mod.Calibration]:
        """The loaded cost-model constants (None = analytic only)."""
        return self._calibration

    def reload_calibration(self, calibration: Any = "default") -> None:
        """Swap the cost model used for future planning. Cached plans are
        untouched: the same (spec, policy) keeps returning the SAME plan
        object until ``cache_clear``."""
        self._calibration = (calibrate_mod.load_default_calibration()
                             if calibration == "default" else calibration)

    def plan(self, spec: LinearSpec, policy: PlanPolicy) -> MatmulPlan:
        """Resolve (spec, policy) to the cheapest eligible backend that is
        not quarantined (module docstring: when every match is).

        Raises:
          ValueError: no registered backend matches the pair."""
        quarantined = self._active_quarantine()  # may clear the cache
        key = (spec, policy)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._hits += 1
                self._cache.move_to_end(key)
                return hit
        matched = self._match_all(spec, policy)
        if not matched:
            raise ValueError(
                f"no registered backend matches spec={spec} policy={policy}; "
                f"registered: {tuple(_REGISTRY)}")
        if quarantined:
            healthy = tuple(be for be in matched if be.name not in quarantined)
            if healthy:
                matched = healthy
            elif policy.vq_mode == "eva":
                degraded = dataclasses.replace(policy, vq_mode="dequant")
                log.warning("all matched backends %s quarantined for spec=%s; "
                            "degrading policy to %s",
                            tuple(be.name for be in matched), spec, degraded)
                built = self.plan(spec, degraded)
                with self._lock:  # the quarantine's changes clear it
                    self._cache[key] = built
                return built
            else:
                log.error("all backends matching spec=%s policy=%s are "
                          "quarantined; ignoring the quarantine", spec, policy)
        built = self._rank(matched, spec, policy)
        with self._lock:
            self._misses += 1
            self._cache[key] = built
            while len(self._cache) > self._maxsize:
                self._cache.popitem(last=False)
        return built

    def _rank(self, matched: Tuple[_Backend, ...], spec: LinearSpec,
              policy: PlanPolicy) -> MatmulPlan:
        """Build every candidate, price it, pick the cheapest (registration
        order breaks ties) and record the ranking on the chosen plan.

        Candidates are compared under ONE model: calibrated when EVERY
        candidate has a usable fitted entry, analytic otherwise — fitted
        microseconds against analytic constants would be no comparison."""
        candidates = [be.planner_fn(spec, policy) for be in matched]
        entries = [self._usable_entry(c.backend) for c in candidates]
        if all(e is not None for e in entries):
            prov = self._calibration.version
        else:
            prov = "analytic"
            entries = [None] * len(candidates)
        scored: List[Tuple[float, int, MatmulPlan]] = []
        for order, (candidate, entry) in enumerate(zip(candidates, entries)):
            us = calibrate_mod.predict_us(
                candidate.cost, entry or calibrate_mod.ANALYTIC)
            scored.append((us, order, candidate))
        scored.sort(key=lambda t: (t[0], t[1]))
        us, _, chosen = scored[0]
        return dataclasses.replace(
            chosen, predicted_us=us, provenance=prov,
            ranking=tuple((c.backend, round(u, 3)) for u, _, c in scored))

    def _usable_entry(self, backend: str
                      ) -> Optional[calibrate_mod.BackendCalibration]:
        """The backend's fitted entry when it rests on at least
        ``calibrate.MIN_FIT_ROWS`` samples, else None."""
        calib = self._calibration
        entry = calib.get(backend) if calib is not None else None
        if entry is not None and entry.rows >= calibrate_mod.MIN_FIT_ROWS:
            return entry
        return None

    @staticmethod
    def _match_all(spec: LinearSpec, policy: PlanPolicy
                   ) -> Tuple[_Backend, ...]:
        registered_backends()
        with _REGISTRY_LOCK:  # snapshot: register_backend may race
            backends = tuple(_REGISTRY.values())
        return tuple(be for be in backends if be.matcher(spec, policy))

    def cache_info(self) -> CacheInfo:
        return CacheInfo(self._hits, self._misses, len(self._cache),
                         self._maxsize)

    def cache_clear(self) -> None:
        """Drop every cached plan and reset the hit/miss counters."""
        with self._lock:
            self._cache.clear()
            self._hits = 0
            self._misses = 0


_PLANNER = Planner()  # the process-global planner of every model layer


def default_planner() -> Planner:
    """The process-global Planner every model-layer entry point uses."""
    return _PLANNER


def reset_quarantine() -> None:
    """Clear the default planner's quarantine and failure counts."""
    _PLANNER.reset_quarantine()


def plan(spec: LinearSpec, policy: PlanPolicy) -> MatmulPlan:
    """Resolve (spec, policy) through the default planner's cache."""
    return _PLANNER.plan(spec, policy)


def candidate_plans(spec: LinearSpec, policy: PlanPolicy
                    ) -> Dict[str, MatmulPlan]:
    """Every matching backend's plan by name, unranked and uncached — for
    timing each candidate, as a calibration run does."""
    return {be.name: be.planner_fn(spec, policy)
            for be in Planner._match_all(spec, policy)}


def first_match_backend(spec: LinearSpec, policy: PlanPolicy
                        ) -> Optional[str]:
    """The backend a first-match dispatch would choose (registration
    order), for showing ranked-vs-first-match decisions."""
    matched = Planner._match_all(spec, policy)
    return matched[0].name if matched else None


def plan_node(p: Dict[str, Any], x: torch.Tensor, *, mode: str,
              policy: PlanPolicy, out_dtype=None) -> MatmulPlan:
    """Plan one linear param node ({"w": ...}, {"vq": ...} or {"vql":
    ...}) for input ``x`` under run ``mode`` — the single dispatch point
    of ``models.common.linear``."""
    out_dtype = out_dtype or x.dtype
    if "vq" in p:
        vq: VQWeight = p["vq"]
        spec = LinearSpec.for_vq(vq, M=x.numel() // vq.K, x_dtype=x.dtype,
                                 out_dtype=out_dtype)
        return _PLANNER.plan(spec, policy.resolve_vq_mode(mode))
    if "vql" in p:
        from repro_torch.core import logits_vq as lvq  # it imports this module

        head = p["vql"]
        spec = lvq.vq_logits_spec(head, M=x.numel() // head.D,
                                  x_dtype=x.dtype, out_dtype=out_dtype)
        return _PLANNER.plan(spec, policy)
    w = p["w"]
    kind = "int8" if (mode == "prefill" and policy.int8_prefill) else "dense"
    spec = LinearSpec.for_dense(w, M=x.numel() // int(w.shape[-2]),
                                x_dtype=x.dtype, out_dtype=out_dtype,
                                kind=kind)
    return _PLANNER.plan(spec, policy)


def plan_vq(x: torch.Tensor, vq: VQWeight, policy: PlanPolicy,
            out_dtype: Optional[torch.dtype] = None) -> MatmulPlan:
    """Plan a bare VQ matmul at x's rows (the ``eva_matmul`` /
    ``vq_matmul`` path): ``vq_mode="none"`` resolves as in decode."""
    spec = LinearSpec.for_vq(vq, M=x.numel() // vq.K, x_dtype=x.dtype,
                             out_dtype=out_dtype or x.dtype)
    return _PLANNER.plan(spec, policy.resolve_vq_mode("decode"))


def preplan_params(params: Any, policy: PlanPolicy, *, mode: str, m: int,
                   act_dtype: torch.dtype, planner: Optional[Planner] = None,
                   site_m: Optional[Dict[str, int]] = None,
                   ) -> List[Tuple[Tuple[Any, ...], MatmulPlan]]:
    """Walk a param tree (dicts, and the layer lists) and plan every
    linear leaf at ``m`` tokens in flight under run ``mode`` — a leaf
    whose path holds a key of ``site_m`` at that key's rows instead
    (a MoE layer's ``"experts"`` at each expert's capacity buffer,
    ``models.common.moe_capacity``; MLA's ``"wkv_b"`` at slots x
    max_len, the whole latent cache an expand decode runs it over) —
    warming the planner cache; returns (path, plan) pairs for logs.
    Pre-planning is a warm-up plus a report, never a constraint."""
    planner = planner or _PLANNER
    out: List[Tuple[Tuple[Any, ...], MatmulPlan]] = []
    site_m = site_m or {}

    def walk(node, path):
        rows = next((r for key, r in site_m.items() if key in path), m)
        if isinstance(node, (list, tuple)):
            for i, sub in enumerate(node):
                walk(sub, path + (i,))
            return
        if not isinstance(node, dict):
            return
        if "vq" in node:
            spec = LinearSpec.for_vq(node["vq"], M=rows, x_dtype=act_dtype,
                                     out_dtype=act_dtype)
            out.append((path, planner.plan(spec, policy.resolve_vq_mode(mode))))
            return
        if "vql" in node:  # the LM head: fp32 logits, as lm_head asks
            from repro_torch.core import logits_vq as lvq

            spec = lvq.vq_logits_spec(node["vql"], M=m, x_dtype=act_dtype,
                                      out_dtype=torch.float32)
            out.append((path, planner.plan(spec, policy)))
            return
        w = node.get("w")
        if isinstance(w, torch.Tensor) and w.dim() >= 2:
            kind = "int8" if (mode == "prefill" and policy.int8_prefill) \
                else "dense"
            spec = LinearSpec.for_dense(w, M=rows, x_dtype=act_dtype,
                                        out_dtype=act_dtype, kind=kind)
            out.append((path, planner.plan(spec, policy)))
            return
        for key, sub in node.items():
            walk(sub, path + (key,))

    walk(params, ())
    return out


def preplan_prefill_buckets(params: Any, policy: PlanPolicy, *,
                            buckets: Tuple[int, ...], act_dtype: torch.dtype,
                            planner: Optional[Planner] = None,
                            ) -> Dict[int, List[Tuple[Tuple[Any, ...],
                                                      MatmulPlan]]]:
    """Plan every linear leaf at EACH prefill length bucket: the engine
    pads prompts to these lengths, so prefill runs at exactly these M."""
    return {m: preplan_params(params, policy, mode="prefill", m=m,
                              act_dtype=act_dtype, planner=planner)
            for m in buckets}


def _plan_fp(spec: LinearSpec, policy: PlanPolicy) -> MatmulPlan:
    out_dt = getattr(torch, spec.out_dtype)

    def run(x, w):
        if w.dtype != x.dtype:
            w = w.to(x.dtype)
        return ops.fp_matmul(x, w, out_dtype=out_dt)

    itemsize = getattr(torch, spec.x_dtype).itemsize
    cost = PlanCost(macs=spec.M * spec.K * spec.N, lookup_adds=0,
                    weight_bytes=spec.K * spec.N * itemsize)
    return MatmulPlan("fp", spec, policy, (), cost, run)


def _plan_int8_torch(spec: LinearSpec, policy: PlanPolicy) -> MatmulPlan:
    out_dt = getattr(torch, spec.out_dtype)

    def run(x, w):
        return ops.int8_matmul(x, w, out_dtype=out_dt)

    cost = PlanCost(macs=spec.M * spec.K * spec.N, lookup_adds=0,
                    weight_bytes=spec.K * spec.N)
    return MatmulPlan("int8_torch", spec, policy, (), cost, run)


def _resolve_eva_epilogue(spec: LinearSpec, policy: PlanPolicy
                          ) -> Tuple[str, Optional[int]]:
    """(epilogue kind, block_v) of the plain EVA backends, frozen once
    per (spec, policy): the one call site of ``ops.select_epilogue`` and
    the auto block sizers."""
    epi = policy.epilogue
    if epi == "auto":
        return ops.select_epilogue(spec.M, spec.V, spec.N, spec.C, spec.k,
                                   spec.d)
    if epi == "blocked":
        if policy.block_v is not None:
            return "blocked", min(policy.block_v, spec.V)
        return "blocked", ops.auto_block_v(spec.M, spec.V, spec.N, spec.C,
                                           spec.k)
    if epi == "recon":
        if policy.block_v is not None:
            return "recon", min(policy.block_v, spec.V)
        return "recon", ops.auto_recon_block_v(spec.V, spec.N, spec.d)
    return epi, None


def _eva_torch_cost(spec: LinearSpec, kind: str) -> PlanCost:
    if kind == "recon":  # dequant's algebra, slab by slab
        return PlanCost(macs=spec.M * spec.K * spec.N,
                        lookup_adds=spec.C * spec.V * spec.N * spec.d,
                        weight_bytes=vq_weight_bytes(spec))
    return PlanCost(
        macs=ops.vq_gemm_macs(spec.M, spec.K, max(spec.k.bit_length() - 1, 0),
                              spec.C, spec.d),
        lookup_adds=ops.epilogue_adds(spec.M, spec.K, spec.N, spec.C, spec.d),
        weight_bytes=vq_weight_bytes(spec))


def _make_eva_torch_planner(kind: str):
    def planner_fn(spec: LinearSpec, policy: PlanPolicy) -> MatmulPlan:
        resolved, bv = _resolve_eva_epilogue(spec, policy)
        assert resolved == kind, (resolved, kind)
        out_dt = getattr(torch, spec.out_dtype)

        def run(x, vq):
            return ops.eva_epilogue_exec(x, vq, kind=kind, block_v=bv,
                                         out_dtype=out_dt)

        config = (("epilogue", kind),) + ((("bv", bv),) if bv is not None
                                          else ())
        return MatmulPlan(f"eva_{kind}", spec, policy, config,
                          _eva_torch_cost(spec, kind), run)

    return planner_fn


register_backend("fp", lambda s, p: s.kind == "dense", _plan_fp)
register_backend("int8_torch",
                 lambda s, p: s.kind == "int8" and p.impl == "torch",
                 _plan_int8_torch)
# the plain EVA decode matmul: under impl="torch" only, as the reference's
# jnp backends match impl="jnp" only (the kernels' eva_fused / eva_split
# match impl="cuda" only)
def _match_eva_torch(kind: str):
    def matcher(spec: LinearSpec, policy: PlanPolicy) -> bool:
        return (spec.kind == "vq" and policy.impl == "torch"
                and policy.vq_mode == "eva"
                and _resolve_eva_epilogue(spec, policy)[0] == kind)

    return matcher


for _kind in EPILOGUES:
    register_backend(f"eva_{_kind}", _match_eva_torch(_kind),
                     _make_eva_torch_planner(_kind))
