"""VQ-Logits: a vector-quantized LM head (``repro/core/logits_vq.py``).

The dense head ``(M, D) @ (D, V)`` is replaced by a codebook of ``Kc``
codeword embeddings, a ``(V,)`` token -> codeword assignment and a
per-token scale; the implied dense head is

    W[:, v] = scale[v] * codebook[:, assign[v]]

so scoring is one small matmul against the codebook, ``(M, D) @ (D,
Kc)``, then a gather along the assignment: ``M*D*Kc`` MACs where the
dense head costs ``M*D*V``.

The head is a param-tree node ``{"vql": VQLogitsHead}``
(``core.quantize.attach_vq_logits_head``), applied by
``models.common.linear`` through the planner as every other weight:
``plan_node`` derives a ``kind="vq_logits"`` spec and the two
formulations below compete on the cost model, the gather (the point of
the scheme) and the expansion to a dense head (the exact oracle). Both
are plain torch, as the reference's are plain ``jnp``: the reference has
no kernel for this head. The gather indexes with the head's ``assign``
tensor (a param), so it reads nothing from the host and a CUDA graph
holds it.

``synthetic_logits_vq`` draws a random head from a ``torch.Generator``;
``fit_logits_vq`` compresses a dense head by k-means over its
scale-normalized columns (``core.vq.kmeans``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import ops
from repro_torch.core import plan as plan_mod
from repro_torch.core import vq as vq_mod


@dataclasses.dataclass
class VQLogitsHead:
    """Compressed LM head: ``W[:, v] = scale[v] * codebook[:, assign[v]]``.

    codebook : (D, Kc) float — codeword output embeddings (columns)
    assign   : (V,) int32    — token -> codeword id
    scale    : (V,) float32  — per-token magnitude (1.0 for synthetic)
    """

    codebook: torch.Tensor
    assign: torch.Tensor
    scale: torch.Tensor

    @property
    def D(self) -> int:
        return int(self.codebook.shape[0])

    @property
    def Kc(self) -> int:
        return int(self.codebook.shape[1])

    @property
    def V(self) -> int:
        return int(self.assign.shape[0])


def expand(head: VQLogitsHead) -> torch.Tensor:
    """The implied dense head (D, V): the exact oracle."""
    w = torch.index_select(head.codebook, 1, head.assign)
    return w * head.scale[None, :].to(w.dtype)


def synthetic_logits_vq(generator: torch.Generator, d_model: int, vocab: int,
                        kc: int, *, dtype: torch.dtype = torch.float32,
                        device=None) -> VQLogitsHead:
    """A random head drawn on ``device`` from ``generator`` (on the same
    device): codebook ~ N(0, 1/d_model), uniform assignment, unit
    scales. A model served with it and the same model with ``{"w":
    expand(head)}`` score the same dense weight."""
    cb = torch.randn((d_model, kc), generator=generator, device=device,
                     dtype=torch.float32) / math.sqrt(d_model)
    assign = torch.randint(0, kc, (vocab,), generator=generator,
                           device=device, dtype=torch.int32)
    return VQLogitsHead(cb.to(dtype), assign,
                        torch.ones((vocab,), dtype=torch.float32,
                                   device=device))


def fit_logits_vq(generator: torch.Generator, w: torch.Tensor, kc: int, *,
                  iters: int = 20) -> VQLogitsHead:
    """Compress a dense head ``w`` (D, V) by k-means over its
    scale-normalized columns: ``scale[v]`` is the column's L2 norm, so
    the clustered points lie on the unit sphere and the codebook holds
    directions, not magnitudes."""
    w = w.float()
    scale = torch.linalg.vector_norm(w, dim=0)
    points = (w / scale.clamp(min=1e-12)[None, :]).T          # (V, D)
    centroids, assign = vq_mod.kmeans(generator, points, kc, iters=iters)
    return VQLogitsHead(centroids.T.contiguous(), assign, scale)


def vq_logits_spec(head: VQLogitsHead, *, M: int, x_dtype: torch.dtype,
                   out_dtype: torch.dtype) -> plan_mod.LinearSpec:
    """Spec of a VQ-Logits head site: K = d_model, N = vocab, k = the
    codebook size Kc."""
    return plan_mod.LinearSpec(
        M=int(M), K=head.D, N=head.V, kind="vq_logits",
        x_dtype=plan_mod.dtype_name(x_dtype),
        out_dtype=plan_mod.dtype_name(out_dtype), k=head.Kc)


# ---------------------------------------------------------------------------
# Planner backends
# ---------------------------------------------------------------------------


def _plan_vql_gather(spec: plan_mod.LinearSpec,
                     policy: plan_mod.PlanPolicy) -> plan_mod.MatmulPlan:
    """Score against the codebook, then gather along the assignment."""
    out_dt = getattr(torch, spec.out_dtype)

    def run(x, head: VQLogitsHead):
        cb = head.codebook
        if cb.dtype != x.dtype:
            cb = cb.to(x.dtype)
        y = ops.fp_matmul(x, cb, out_dtype=out_dt)            # (..., Kc)
        y = torch.index_select(y, -1, head.assign)             # (..., V)
        return y * head.scale.to(out_dt)

    itemsize = getattr(torch, spec.x_dtype).itemsize
    cost = plan_mod.PlanCost(
        macs=spec.M * spec.K * spec.k,
        lookup_adds=spec.M * spec.N,
        weight_bytes=spec.K * spec.k * itemsize + spec.N * 8,
        intermediate_bytes=spec.M * spec.k * out_dt.itemsize)
    return plan_mod.MatmulPlan("vql_gather_torch", spec, policy, (), cost, run)


def _plan_vql_dequant(spec: plan_mod.LinearSpec,
                      policy: plan_mod.PlanPolicy) -> plan_mod.MatmulPlan:
    """Expand to the dense head, then a dense matmul: never the cost
    winner at decode M, but ranked beside the gather, and its oracle."""
    out_dt = getattr(torch, spec.out_dtype)

    def run(x, head: VQLogitsHead):
        w = expand(head)
        if w.dtype != x.dtype:
            w = w.to(x.dtype)
        return ops.fp_matmul(x, w, out_dtype=out_dt)

    itemsize = getattr(torch, spec.x_dtype).itemsize
    cost = plan_mod.PlanCost(
        macs=spec.M * spec.K * spec.N,
        lookup_adds=spec.K * spec.N,
        weight_bytes=spec.K * spec.k * itemsize + spec.N * 8,
        intermediate_bytes=spec.K * spec.N * itemsize)
    return plan_mod.MatmulPlan("vql_dequant_torch", spec, policy, (), cost,
                               run)


plan_mod.register_backend("vql_gather_torch",
                          lambda s, p: s.kind == "vq_logits", _plan_vql_gather)
plan_mod.register_backend("vql_dequant_torch",
                          lambda s, p: s.kind == "vq_logits", _plan_vql_dequant)
