"""Plan-once / execute-many dispatch for every model-layer matmul (the
subset of ``repro/core/plan.py`` the serving path needs).

  LinearSpec : frozen, hashable shape + weight-kind signature of one
               matmul site, derived from ``(x, param node)``; the
               KV-VQ decode-attention site is matmul-shaped too
               (``kvq_attention_spec``).
  PlanPolicy : frozen, validated execution policy (vq_mode, impl,
               int8_prefill).
  MatmulPlan : the chosen backend, its resolved config and cost estimate,
               and the ``run`` callable.
  Planner    : LRU cache (LinearSpec, PlanPolicy) -> MatmulPlan; the same
               pair returns the SAME plan object.

Backends by weight kind (``fp`` and ``int8_torch`` register here, the
others from the kernel wrappers in ``_KERNEL_BACKEND_MODULES``, imported
lazily on the first plan):

  dense    : ``fp`` (``torch.matmul``) on any impl;
  int8     : ``int8_torch`` | ``int8_cuda`` (kernel B6) — dense prefill
             matmuls under ``int8_prefill``;
  vq       : ``eva_fused`` (B1) in decode, ``dequant`` (B3) elsewhere;
  kvq_attn : ``kvq_dequant_torch`` | ``kvq_flash_cuda`` (B7) — decode
             attention over a vector-quantized KV cache.

``impl="cuda"`` runs the hand-written kernels (their wrappers take the
plain version only for tensors on the CPU); ``impl="torch"`` runs the
plain PyTorch formulations on any device — the reference a run on the
card is compared with. Cost ranking, calibration and backend quarantine
are not ported (ROADMAP A4), so exactly one backend matches each pair:
where the reference lets ``int8_jnp`` and ``kvq_dequant_jnp`` match
every impl and ranks them against the kernels, the port's matchers split
the int8 and kvq_attn kinds by impl instead.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import threading
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core import ops
from repro_torch.core.vq import VQWeight

WEIGHT_KINDS = ("dense", "int8", "vq", "kvq_attn")
VQ_MODES = ("none", "eva", "dequant")
IMPLS = ("cuda", "torch")


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Shape + weight-kind signature of one matmul site. ``kind`` is the
    resolved weight kind: "dense", "int8" (a dense weight run through the
    INT8 prefill GEMM), "vq" or "kvq_attn" (see ``kvq_attention_spec``).
    The VQ geometry fields are zero for dense and int8 sites."""

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
                   x_dtype=_dtype_name(x_dtype),
                   out_dtype=_dtype_name(out_dtype), C=vq.C, V=vq.V,
                   k=int(vq.codebooks.shape[-1]), d=vq.d,
                   splits=tuple(vq.splits))

    @classmethod
    def for_dense(cls, w: torch.Tensor, *, M: int, x_dtype: torch.dtype,
                  out_dtype: torch.dtype, kind: str = "dense"
                  ) -> "LinearSpec":
        """Spec for a dense (.., K, N) weight; ``kind`` may be "int8" for
        the INT8 prefill GEMM path (ValueError on an unknown kind)."""
        return cls(M=int(M), K=int(w.shape[-2]), N=int(w.shape[-1]),
                   kind=kind, x_dtype=_dtype_name(x_dtype),
                   out_dtype=_dtype_name(out_dtype))


@dataclasses.dataclass(frozen=True)
class PlanPolicy:
    """Execution policy for one matmul.

    ``vq_mode`` : "eva" | "dequant" | "none" ("none" resolves by run mode:
                  EVA in decode, the dequant baseline elsewhere).
    ``impl``    : "cuda" (the hand-written kernels) | "torch" (the plain
                  PyTorch formulations).
    ``int8_prefill`` : route dense prefill matmuls through the INT8 GEMM.
    """

    vq_mode: str = "none"
    impl: str = "cuda"
    int8_prefill: bool = False

    def __post_init__(self):
        if self.vq_mode not in VQ_MODES:
            raise ValueError(
                f"unknown vq_mode {self.vq_mode!r}; expected one of {VQ_MODES}")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; expected one of {IMPLS}")

    def resolve_vq_mode(self, mode: str) -> "PlanPolicy":
        """Resolve vq_mode="none" by run mode (decode -> EVA, else the
        dequant baseline)."""
        if self.vq_mode != "none":
            return self
        return dataclasses.replace(
            self, vq_mode="eva" if mode == "decode" else "dequant")


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Analytic estimates: multiply-accumulates, add-only lookup or
    reconstruction work, and per-call weight bytes."""

    macs: int
    lookup_adds: int
    weight_bytes: int


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """A frozen, executable matmul choice."""

    backend: str
    spec: LinearSpec
    policy: PlanPolicy
    config: Tuple[Tuple[str, Any], ...]
    cost: PlanCost
    run: Callable[[Any, Any], Any]

    def execute(self, x, leaf):
        """Run the planned matmul on ``leaf`` (a VQWeight or dense w)."""
        return self.run(x, leaf)


def kvq_attention_spec(*, B: int, S: int, H: int, Hk: int, hd: int,
                       idx_width: int, entries: int, x_dtype: torch.dtype,
                       out_dtype: torch.dtype) -> LinearSpec:
    """Spec of a KV-VQ decode-attention site (kind="kvq_attn"), mapped
    onto the matmul fields as in the reference: M=batch, K=cache length
    S, N=H*hd, C=Hk, V=idx_width (uint8 indices per token and head),
    k=entries (codebook rows), d=hd."""
    return LinearSpec(M=int(B), K=int(S), N=int(H * hd), kind="kvq_attn",
                      x_dtype=_dtype_name(x_dtype),
                      out_dtype=_dtype_name(out_dtype), C=int(Hk),
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
_KERNEL_BACKEND_MODULES = (
    "repro_torch.kernels.fused_vq_matmul.ops",
    "repro_torch.kernels.dequant_gemv.ops",
    "repro_torch.kernels.int8_gemm.ops",
    "repro_torch.kernels.flash_decode.ops",
)


def register_backend(name: str,
                     matcher: Callable[[LinearSpec, PlanPolicy], bool],
                     planner_fn: Callable[[LinearSpec, PlanPolicy], MatmulPlan],
                     ) -> None:
    """Register (or idempotently re-register) a matmul backend."""
    with _REGISTRY_LOCK:
        _REGISTRY[name] = _Backend(name, matcher, planner_fn)


def registered_backends() -> Tuple[str, ...]:
    for mod in _KERNEL_BACKEND_MODULES:
        importlib.import_module(mod)
    return tuple(_REGISTRY)


CacheInfo = collections.namedtuple("CacheInfo", "hits misses currsize maxsize")


class Planner:
    """LRU-cached (LinearSpec, PlanPolicy) -> MatmulPlan resolver."""

    def __init__(self, maxsize: int = 1024):
        self._cache: "collections.OrderedDict[Tuple[LinearSpec, PlanPolicy], MatmulPlan]" = (
            collections.OrderedDict())
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    def plan(self, spec: LinearSpec, policy: PlanPolicy) -> MatmulPlan:
        """Resolve (spec, policy) to the registered backend that matches.

        Raises:
          ValueError: no backend, or more than one, matches the pair."""
        key = (spec, policy)
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._hits += 1
                self._cache.move_to_end(key)
                return hit
        registered_backends()
        with _REGISTRY_LOCK:
            matched = [be for be in _REGISTRY.values()
                       if be.matcher(spec, policy)]
        if len(matched) != 1:
            raise ValueError(
                f"{len(matched)} registered backends match spec={spec} "
                f"policy={policy} (want exactly one); registered: "
                f"{tuple(_REGISTRY)}")
        built = matched[0].planner_fn(spec, policy)
        with self._lock:
            self._misses += 1
            self._cache[key] = built
            while len(self._cache) > self._maxsize:
                self._cache.popitem(last=False)
        return built

    def cache_info(self) -> CacheInfo:
        return CacheInfo(self._hits, self._misses, len(self._cache),
                         self._maxsize)


_PLANNER = Planner()  # the process-global planner of every model layer


def plan(spec: LinearSpec, policy: PlanPolicy) -> MatmulPlan:
    """Resolve (spec, policy) through the default planner's cache."""
    return _PLANNER.plan(spec, policy)


def plan_node(p: Dict[str, Any], x: torch.Tensor, *, mode: str,
              policy: PlanPolicy, out_dtype=None) -> MatmulPlan:
    """Plan one linear param node ({"w": ...} or {"vq": ...}) for input
    ``x`` under run ``mode`` — the single dispatch point of
    ``models.common.linear``."""
    out_dtype = out_dtype or x.dtype
    if "vq" in p:
        vq: VQWeight = p["vq"]
        spec = LinearSpec.for_vq(vq, M=x.numel() // vq.K, x_dtype=x.dtype,
                                 out_dtype=out_dtype)
        return _PLANNER.plan(spec, policy.resolve_vq_mode(mode))
    w = p["w"]
    kind = "int8" if (mode == "prefill" and policy.int8_prefill) else "dense"
    spec = LinearSpec.for_dense(w, M=x.numel() // int(w.shape[-2]),
                                x_dtype=x.dtype, out_dtype=out_dtype,
                                kind=kind)
    return _PLANNER.plan(spec, policy)


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


register_backend("fp", lambda s, p: s.kind == "dense", _plan_fp)
register_backend("int8_torch",
                 lambda s, p: s.kind == "int8" and p.impl == "torch",
                 _plan_int8_torch)
