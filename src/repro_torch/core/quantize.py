"""Model-level VQ quantization pass (``repro/core/quantize.py``).

Every eligible FC weight under a block segment becomes ``{"vq":
VQWeight}``; same-input projection families are grouped into one wide
leaf (wq|wk|wv -> "wqkv", gate|up -> "gu") with recorded ``splits``.
A MoE layer's experts (under the ``"experts"`` segment, stacked on a
leading E axis) become one VQWeight stacked on E, gate|up grouped into
``gu`` expert by expert. Embeddings, lm_head, norms and the MoE router
(its N = E is below the quantizer's 64) stay dense; an fp32 leaf that
the reference's stacked layout makes large (its elements times its
segment's layers) is cast to bf16 for serving.

Three methods, as the reference's:

  fit        k-means additive VQ of the real weights (``core.vq.fit_vq``
             at 10 Lloyd iterations, no refinement; one fit per stacked
             weight of a MoE site), on the params' target device;
  synthetic  random valid indices and codebooks; it reads only each
             weight's SHAPE, so it accepts params whose block weights
             live on the ``meta`` device (``Model.init(...,
             block_device="meta")``) and builds a full-width model
             straight from shapes;
  specs      every tensor on the ``meta`` device (shapes and dtypes, no
             allocation), the reference's ``ShapeDtypeStruct`` tree.

Quantizing the LM head and the shard-aware grouping options are not
ported (the port serves on one card).

``count_vq_layers`` and ``compressed_model_bytes`` count the quantized
linears and their bytes (the port holds one VQWeight a layer, so a site
counts once per layer where the reference's stacked node counts once;
an E-stacked expert site counts E linears).

``attach_kv_codebooks`` gives every attention node the per-head KV-VQ
codebooks a compressed cache encodes against (``kv_cb``: {"k", "v"} of
shape (Hk, R, 256, vec_d); an MLA node {"lat": (1, R, 256, vec_d)}, its
latent one "head" of width kv_lora_rank): the grid lattice, or layer
l's slice of a calibrated tree (``calibrate_kv_codebooks``, k-means
over one fp prefill's K/V). ``kv_codebook_tree`` collects them stacked
by layer under each segment's cache subtree (``"layers"`` -> ``"body"``,
``"pre_layers"`` -> ``"pre"``), the layout
``serve/kvcache.encode_prefill_cache`` takes.

``attach_vq_logits_head`` replaces the dense LM head with a VQ-Logits
head (``core/logits_vq.py``) fitted by k-means.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device, tensor_device
from repro_torch.core import logits_vq as lvq
from repro_torch.core.vq import (KVQuantConfig, VQWeight, fit_kv_codebooks,
                                 fit_vq, kv_grid_codebooks, synthetic_vq)

if TYPE_CHECKING:  # models.api imports this module
    from repro_torch.models.common import ModelConfig

_BLOCK_SEGMENTS = (
    "layers", "pre_layers", "groups", "trail", "encoder", "decoder", "experts",
)
_MIN_DIM = 64  # don't quantize tiny matrices

# same-input projection families: (member keys, grouped key, sibling that
# identifies the consumer), as in the reference
_GROUP_FAMILIES = (
    (("wq", "wk", "wv"), "wqkv", "wo"),
    (("wq", "wk", "wv"), "wqkv", "w_if"),
    (("wq", "wkv_a"), "wq_kva", "wkv_b"),
    (("gate", "up"), "gu", "down"),
)
_NO_GROUP_KEYS = ("cross_attn", "xattn")
# cache subtree of each stacked param segment
_KV_STACK_SEGMENTS = {"layers": "body", "pre_layers": "pre"}
_BF16_MIN_SIZE = 65536


def _eligible(path: Tuple[str, ...], w: torch.Tensor) -> bool:
    if not any(seg in path for seg in _BLOCK_SEGMENTS):
        return False
    if w.ndim < 2:
        return False
    return w.shape[-2] >= _MIN_DIM and w.shape[-1] >= _MIN_DIM


def _to_serving_dtype(leaf: torch.Tensor, stack: int = 1) -> torch.Tensor:
    """bf16 for an fp32 leaf of at least ``_BF16_MIN_SIZE`` elements as
    the reference stacks it: a leaf of one of ``stack`` layers (a segment
    list's length) counts ``stack`` times."""
    if leaf.dtype != torch.float32 or leaf.numel() * stack < _BF16_MIN_SIZE:
        return leaf
    return leaf.to(torch.bfloat16)


def quantize_params(params: Any, cfg: ModelConfig, *, method: str = "fit",
                    generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None) -> Any:
    """Replace eligible {"w": ...} linears with {"vq": VQWeight} on
    ``device`` (``method`` in the module docstring; the draws of "fit"
    and "synthetic" from ``generator``, a generator on that device;
    "fit" defaults to seed 0 there), grouping same-input families; cast
    large dense fp32 leaves to bf16. Under "specs" every tensor is put
    on the ``meta`` device.

    Raises:
      ValueError: an unknown ``method``; "synthetic" without a
        generator; a dense leaf that must be kept (or, under "fit", a
        weight) lives on the meta device; K not divisible by vq_d.
    """
    if method not in ("fit", "synthetic", "specs"):
        raise ValueError(f"unknown method {method}")
    dev = (torch.device("meta") if method == "specs"
           else resolve_device(device))
    if generator is None and method == "synthetic":
        raise ValueError("quantize_params(method='synthetic') needs a "
                         "torch.Generator on the target device")
    if generator is None and method == "fit":
        generator = torch.Generator(device=dev).manual_seed(0)
    d, n, C = cfg.vq_d, cfg.vq_n, cfg.vq_C

    def make_vq(w: torch.Tensor, N: int, splits=()) -> VQWeight:
        K, lead = int(w.shape[-2]), tuple(w.shape[:-2])
        if K % d:
            raise ValueError(f"K={K} not divisible by vq_d={d}")
        if method == "synthetic":
            return synthetic_vq(generator, K, N, d=d, n=n, C=C,
                                splits=splits, lead=lead, device=dev)
        if method == "specs":
            meta = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
            return VQWeight(
                idx=meta(lead + (C, K // d, N),
                         torch.uint8 if n <= 8 else torch.int32),
                codebooks=meta(lead + (C, d, 2 ** n), torch.float32),
                scale=meta(lead + (N,), torch.float32),
                K=K, N=N, d=d, n=n, splits=tuple(splits))
        if w.is_meta:
            raise ValueError("quantize_params(method='fit') needs the dense "
                             "weights' values; they live on the meta device")
        flat = w.to(dev).reshape(-1, K, N)
        fits = [fit_vq(generator, flat[i], d=d, n=n, C=C, kmeans_iters=10,
                       refine_rounds=0) for i in range(flat.shape[0])]
        stack = lambda name: torch.stack(
            [getattr(f, name) for f in fits]).reshape(
                lead + tuple(getattr(fits[0], name).shape))
        return VQWeight(idx=stack("idx"), codebooks=stack("codebooks"),
                        scale=stack("scale"), K=K, N=N, d=d, n=n,
                        splits=tuple(splits))

    def groupable(node, path, members, sibling) -> bool:
        if path and path[-1] in _NO_GROUP_KEYS:
            return False
        if sibling not in node or not all(m in node for m in members):
            return False
        shapes = []
        for m in members:
            sub = node[m]
            if not (isinstance(sub, dict) and "w" in sub
                    and _eligible(path + (m,), sub["w"])):
                return False
            shapes.append(tuple(sub["w"].shape))
        if any(s[:-1] != shapes[0][:-1] for s in shapes):
            return False
        has_b = [("b" in node[m]) for m in members]
        return all(has_b) or not any(has_b)

    def group(node, path):
        out = dict(node)
        for members, gkey, sibling in _GROUP_FAMILIES:
            if not groupable(out, path, members, sibling):
                continue
            splits = tuple(int(out[m]["w"].shape[-1]) for m in members)
            w = (torch.cat([out[m]["w"] for m in members], dim=-1)
                 if method == "fit" else out[members[0]]["w"])
            grouped = {"vq": make_vq(w, sum(splits), splits)}
            if "b" in out[members[0]]:
                grouped["b"] = torch.cat(
                    [out[m]["b"] for m in members], dim=-1).to(dev)
            for m in members:
                del out[m]
            out[gkey] = grouped
        return out

    def walk(node, path, stack):
        if isinstance(node, list):   # a segment's layers: stacked by the
            return [walk(v, path + (str(i),), len(node))   # reference
                    for i, v in enumerate(node)]
        if isinstance(node, dict):
            if "vq" in node or "vql" in node:  # already compressed
                return node
            if "w" in node and _eligible(path, node["w"]):
                w = node["w"]
                new = {kk: vv.to(dev) for kk, vv in node.items() if kk != "w"}
                new["vq"] = make_vq(w, int(w.shape[-1]))
                return new
            node = group(node, path)
            return {kk: walk(vv, path + (kk,), stack)
                    for kk, vv in node.items()}
        if node.is_meta and method != "specs":
            raise ValueError(
                f"dense leaf {'/'.join(path)} has no values (meta device); "
                "only quantized block weights may be built from shapes")
        return _to_serving_dtype(node.to(dev), stack)

    return walk(params, (), 1)


def vq_nodes(params: Any):
    """Every ``{"vq": VQWeight}`` node of a param tree (dicts and lists)."""
    if isinstance(params, list):
        for v in params:
            yield from vq_nodes(v)
    elif isinstance(params, dict):
        if "vq" in params:
            yield params
        for v in params.values():
            yield from vq_nodes(v)


def count_vq_layers(params: Any) -> int:
    """Number of quantized linears (one per layer and site, E per
    E-stacked expert site)."""
    return sum(node["vq"].lead for node in vq_nodes(params))


def compressed_model_bytes(params: Any) -> Tuple[int, int]:
    """(bytes of the VQ'd leaves, bytes of the same weights dense in
    bf16), every stacked expert counted."""
    vq_b = dense_b = 0
    for node in vq_nodes(params):
        v = node["vq"]
        vq_b += v.compressed_bytes()
        dense_b += v.lead * v.K * v.N * 2
    return vq_b, dense_b


def _is_gqa_attn_node(node: Any, path: Tuple[str, ...]) -> bool:
    return (isinstance(node, dict) and "wo" in node
            and ("wq" in node or "wqkv" in node) and "wkv_b" not in node
            and (not path or path[-1] not in _NO_GROUP_KEYS))


def attach_kv_codebooks(params: Any, cfg: ModelConfig, kvq: KVQuantConfig,
                        *, codebooks: Optional[Dict[str, Any]] = None) -> Any:
    """A new param tree whose every attention node carries ``kv_cb``:
    {"k", "v"} (Hk, R, 256, vec_d) on a GQA node, {"lat"} (1, R, 256,
    vec_d) over the kv_lora_rank latent on an MLA node, on the params'
    device. ``codebooks`` (a tree of ``calibrate_kv_codebooks``, {"body":
    {"k": (L, Hk, R, 256, vec_d), "v": ...}, "pre": ...}) gives layer l
    of each segment its slice l; every leaf it lacks, and every leaf
    when it is None, is the deterministic ``kv_grid_codebooks`` lattice
    of ``kvq``, one tensor shared by all layers (read only).
    Idempotent: existing ``kv_cb`` nodes are replaced; everything else
    is shared with ``params``, not copied.

    Raises:
      ValueError: head_dim (MLA: kv_lora_rank) not divisible by
        ``kvq.vec_d``.
    """
    dev = tensor_device(params)
    if cfg.use_mla:
        grid = {"lat": kv_grid_codebooks(1, cfg.kv_lora_rank, kvq, device=dev)}
    else:
        cb = kv_grid_codebooks(cfg.num_kv_heads, cfg.head_dim, kvq,
                               device=dev)
        grid = {"k": cb, "v": cb}

    def cbs(stack: Optional[str], layer: int) -> Dict[str, torch.Tensor]:
        fitted = (codebooks or {}).get(stack) or {}
        return {n: (fitted[n][layer].to(dev) if n in fitted else g)
                for n, g in grid.items()}

    def walk(node, path, stack, layer):
        if isinstance(node, list):
            seg = _KV_STACK_SEGMENTS.get(path[-1]) if path else None
            return [walk(v, path + (str(i),), seg or stack,
                         i if seg else layer) for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        if _is_gqa_attn_node(node, path) or "wkv_b" in node:   # MLA
            return {**node, "kv_cb": cbs(stack, layer)}
        return {k: walk(v, path + (k,), stack, layer)
                for k, v in node.items()}

    return walk(params, (), None, 0)


def kv_codebook_tree(params: Any) -> Dict[str, Any]:
    """The attached ``kv_cb`` nodes keyed by cache subtree, each leaf
    stacked over the layers of its segment: {"body": {"k": (L, Hk, R,
    256, vd), "v": ...}} (MLA: {"lat": (L, 1, R, 256, vd)}; a
    ``"pre"`` subtree for ``"pre_layers"``).

    Raises:
      ValueError: params carry no kv_cb nodes (attach first)."""
    found: Dict[str, list] = {}

    def walk(node, stack):
        if isinstance(node, list):
            for v in node:
                walk(v, stack)
        elif isinstance(node, dict):
            for k, v in node.items():
                if k == "kv_cb" and stack:
                    found.setdefault(stack, []).append(v)
                else:
                    walk(v, _KV_STACK_SEGMENTS.get(k, stack))

    walk(params, None)
    if not found:
        raise ValueError("params carry no kv_cb nodes "
                         "(run attach_kv_codebooks first)")
    return {stack: {n: torch.stack([c[n] for c in cbs]) for n in cbs[0]}
            for stack, cbs in found.items()}


def calibrate_kv_codebooks(model: Any, params: Any, batch: Dict[str, Any],
                           kvq: KVQuantConfig, *,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict[str, Any]:
    """Per-layer, per-head KV codebooks fitted to calibration prompts.

    Runs one fp prefill of ``batch`` ({"tokens": (B, S)}) under the
    default policy (on the card, the kernels) with attention chunks of
    16, as the reference's, and fits each layer's K and V (an MLA node's
    latent) through ``core.vq.fit_kv_codebooks``: the layers of a
    segment go on the head axis of ONE batched k-means, so a segment
    costs one k-means a leaf and stage. Draws come from ``generator``
    (default seed 0 on the params' device).

    Returns:
      A tree for ``attach_kv_codebooks(codebooks=...)``: {"body": {"k":
      (L, Hk, R, 256, vec_d), "v": ...}, "pre": ...} (MLA subtrees
      {"lat": (L, 1, R, 256, vec_d)}).

    Raises:
      ValueError: the prefill cache has no quantizable KV node.
    """
    from repro_torch.models.common import RunConfig  # models imports us

    if generator is None:
        generator = torch.Generator(
            device=tensor_device(params)).manual_seed(0)
    rc = RunConfig(mode="prefill", attn_chunk=16)
    with torch.no_grad():
        _, cache = model.prefill(params, batch, rc)

    def fit_stack(x: torch.Tensor) -> torch.Tensor:
        # x (L, B, S, Hk, dim) -> (L, Hk, R, E, vd): layers x heads batched
        L, Hk, dim = x.shape[0], x.shape[-2], x.shape[-1]
        smp = x.reshape(L, -1, Hk, dim).transpose(0, 1).reshape(
            -1, L * Hk, dim)
        cb = fit_kv_codebooks(generator, smp, kvq)
        return cb.reshape((L, Hk) + tuple(cb.shape[1:]))

    out: Dict[str, Any] = {}
    for name, node in cache.items():
        if not isinstance(node, dict):
            continue
        if "k" in node and "v" in node:
            out[name] = {"k": fit_stack(node["k"]), "v": fit_stack(node["v"])}
        elif "latent" in node:
            out[name] = {"lat": fit_stack(node["latent"][..., None, :])}
    if not out:
        raise ValueError("prefill cache carries no quantizable KV nodes")
    return out


def attach_vq_logits_head(params: Any, kc: int, *,
                          generator: Optional[torch.Generator] = None,
                          iters: int = 20) -> Any:
    """Replace the dense LM head with a VQ-Logits head
    (``core.logits_vq``): the ``{"w": (D, V)}`` node under ``lm_head``
    becomes ``{"vql": VQLogitsHead}``, fitted by k-means over the head's
    scale-normalized columns, its draws from ``generator`` (default: seed
    0 on the head's device). Idempotent: an attached head is re-fitted
    from its implied dense weight.

    Raises:
      ValueError: the params have no separate ``lm_head`` node (tied
        embeddings score through the embedding table), or the head is
        weight-VQ quantized (compress one family at a time).
    """
    if not (isinstance(params, dict)
            and isinstance(params.get("lm_head"), dict)):
        raise ValueError(
            "attach_vq_logits_head: params have no lm_head node "
            "(tie_embeddings models have no separate head to compress)")
    node = params["lm_head"]
    if "vql" in node:
        w = lvq.expand(node["vql"])
    elif "vq" in node:
        raise ValueError(
            "attach_vq_logits_head: lm_head is weight-VQ quantized; "
            "compress one family at a time")
    else:
        w = node["w"]
    if generator is None:
        generator = torch.Generator(device=w.device).manual_seed(0)
    out = dict(params)
    out["lm_head"] = {"vql": lvq.fit_logits_vq(generator, w, kc, iters=iters)}
    return out
