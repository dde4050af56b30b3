"""Named sharding rules for params, optimizer state, caches and batches
(``repro/runtime/sharding.py``): Megatron-style tensor parallelism over
the ``model`` axis, data parallelism over ``("pod", "data")``, ZeRO-1
optimizer-state sharding over ``data``, expert parallelism for MoE
stacks, and sequence-parallel cache sharding for long-context decode.

The rules are the reference's, fallbacks included, and so are the specs:
a spec is a tuple with one entry a dim, each an axis name, a tuple of
names, or None (what the reference's ``PartitionSpec`` holds, a
one-name tuple written as the name). They are computed on a mesh given
as its axis sizes, ``{"pod": 2, "data": 16, "model": 16}`` (or a
``torch.distributed`` ``DeviceMesh``), so the production meshes can be
checked without a process a device.

The specs are in the reference's stacked layout: the port keeps a
segment's layers (``"layers"``, ``"groups"``, ...) as a list of
per-layer dicts, and its spec is ONE node whose specs lead with the
layer axis L, as the reference's stacked leaves. ZeRO-1's "leading
stacked axis over ``data``" then means contiguous blocks of L / |data|
layers owned by each data rank (``zero1_owners``), which is how a
sharded L axis splits. ``to_placements`` turns a spec into ``DTensor``
placements on a ``DeviceMesh``.

Layout reminders (stacked):
  dense weight leaves under layers:         (L, ..., K, N)
  VQ idx (L, ..., C, V, N); codebooks (L, ..., C, d, 2^n); scale (L, ..., N)
  grouped families ("wqkv", "gu"): one wide VQWeight, N = sum(splits),
  column-parallel like their members
  caches: attention k/v (L, B, S, Hk, hd); MLA latent (L, B, S, r);
          recurrent states (G, B, ...).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.convert import _STACKED, is_vq
from repro_torch.core.vq import VQWeight

Spec = Tuple[Any, ...]
MeshLike = Union[Mapping[str, int], Any]

# output projections back into the residual stream -> row-parallel
_ROW_KEYS = {"wo", "down", "out"}
# everything else 2-D under a block is column-parallel
_REPLICATE_KEYS = {"router", "wr", "w_if", "wi", "wf", "rz", "lam", "cb"}


def splits_shard_aligned(splits: Tuple[int, ...], N: int,
                         shards: int) -> bool:
    """True when every member boundary of a grouped projection family
    (column-concatenated widths ``splits`` summing to ``N``) falls on a
    shard boundary of the N axis split ``shards``-ways."""
    if shards <= 1:
        return True
    if N % shards:
        return False
    if not splits:
        return True
    shard = N // shards
    off = 0
    for width in splits[:-1]:
        off += width
        if off % shard:
            return False
    return True


def mesh_axes(mesh: MeshLike) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a dict of sizes or a
    ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def P(*parts) -> Spec:
    """A spec, a one-name tuple written as the name (as the reference's
    ``PartitionSpec`` holds it)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


def _none(nd: int) -> Spec:
    return P(*([None] * nd))


@dataclasses.dataclass(frozen=True)
class _Shape:
    """A leaf's shape in the stacked layout (no storage)."""
    shape: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _leaf(x) -> bool:
    return hasattr(x, "ndim")


def stacked_shapes(tree: Any, lead: Tuple[int, ...] = ()) -> Any:
    """``tree`` in the reference's stacked layout, every tensor a
    ``_Shape``: a segment's list of L per-layer dicts becomes one node
    whose shapes lead with L (nothing is allocated)."""
    if is_vq(tree):
        return VQWeight(idx=_Shape(lead + tuple(tree.idx.shape)),
                        codebooks=_Shape(lead + tuple(tree.codebooks.shape)),
                        scale=_Shape(lead + tuple(tree.scale.shape)),
                        K=tree.K, N=tree.N, d=tree.d, n=tree.n,
                        splits=tuple(tree.splits))
    if isinstance(tree, dict):
        return {k: (stacked_shapes(v[0], lead + (len(v),))
                    if k in _STACKED and isinstance(v, list) and v
                    else stacked_shapes(v, lead))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(stacked_shapes(v, lead) for v in tree)
    if _leaf(tree):
        return _Shape(lead + tuple(tree.shape))
    return tree


def _dp_axes(axes: Dict[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axes)


def _model_axis(axes: Dict[str, int]) -> Optional[str]:
    return "model" if "model" in axes else None


def _dim(axes: Dict[str, int], axis: Optional[str]) -> int:
    return 1 if axis is None else axes[axis]


def _pad_front(spec_tail: Tuple, ndim: int) -> Spec:
    return P(*([None] * (ndim - len(spec_tail)) + list(spec_tail)))


def _replicated(node: Any) -> Any:
    if is_vq(node):
        return dataclasses.replace(node, idx=_none(node.idx.ndim),
                                   codebooks=_none(node.codebooks.ndim),
                                   scale=_none(node.scale.ndim))
    if isinstance(node, dict):
        return {k: _replicated(v) for k, v in node.items()}
    if _leaf(node):
        return _none(node.ndim)
    return node


def _vq_spec(vq, idx, codebooks, scale):
    return VQWeight(idx=idx, codebooks=codebooks, scale=scale, K=vq.K,
                    N=vq.N, d=vq.d, n=vq.n, splits=tuple(vq.splits))


def _linear_specs(node: dict, axes: Dict[str, int], *, row: bool,
                  shard_expert: bool) -> dict:
    """Specs for one linear param dict ({"w"[,b]} or {"vq"[,b]}); every
    choice falls back (row <-> col <-> replicate) when the preferred axis
    does not divide the ``model`` dim."""
    ma = _model_axis(axes)
    mdim = _dim(axes, ma)
    out = {}

    def div(x):
        return ma is not None and x % mdim == 0

    col_ok = True
    if "w" in node:
        w = node["w"]
        nd = w.ndim
        K, N = w.shape[-2], w.shape[-1]
        if shard_expert:
            out["w"] = _pad_front((ma, None, None), nd)  # (L, E, K, N): E
        elif row and div(K):
            out["w"] = _pad_front((ma, None), nd)        # shard K
        elif div(N):
            out["w"] = _pad_front((ma,), nd)             # shard N
            row = False
        elif div(K):
            out["w"] = _pad_front((ma, None), nd)
            row = True
        else:
            out["w"] = _none(nd)
            col_ok = False
    if "vq" in node:
        vq = node["vq"]
        nd_idx, nd_cb, nd_sc = (vq.idx.ndim, vq.codebooks.ndim,
                                vq.scale.ndim)
        V, N = vq.idx.shape[-2], vq.idx.shape[-1]
        if shard_expert:
            lead = nd_idx - 3
            ex = lambda nd: (_pad_front((ma,) + (None,) * (nd - lead), nd)
                             if lead >= 1 else _none(nd))
            out["vq"] = _vq_spec(vq, ex(nd_idx), ex(nd_cb), ex(nd_sc))
        elif row and div(V):
            # shard V (the K/d axis); lookup partial sums reduce over model
            out["vq"] = _vq_spec(vq, _pad_front((ma, None), nd_idx),
                                 _none(nd_cb), _none(nd_sc))
        elif div(N) and splits_shard_aligned(vq.splits, N, mdim):
            # shard N: indices and scales column-sharded, OC replicated
            out["vq"] = _vq_spec(vq, _pad_front((ma,), nd_idx),
                                 _none(nd_cb), _pad_front((ma,), nd_sc))
        elif div(V):
            # a misaligned grouped family: V-sharded contraction, so the
            # output (and its bias) is not column-sharded
            col_ok = False
            out["vq"] = _vq_spec(vq, _pad_front((ma, None), nd_idx),
                                 _none(nd_cb), _none(nd_sc))
        else:
            col_ok = False
            out["vq"] = _vq_spec(vq, _none(nd_idx), _none(nd_cb),
                                 _none(nd_sc))
    if "b" in node:
        b = node["b"]
        if row or shard_expert or not col_ok or not div(b.shape[-1]):
            out["b"] = _none(b.ndim)
        else:
            out["b"] = _pad_front((ma,), b.ndim)
    return out


def param_pspecs(params: Any, mesh: MeshLike) -> Any:
    """The spec tree of ``params`` (the port's tree, or one already in
    the stacked layout) in the stacked layout."""
    axes = mesh_axes(mesh)
    ma = _model_axis(axes)
    mdim = _dim(axes, ma)

    def walk(node, path):
        if isinstance(node, dict):
            if ("w" in node and not isinstance(node["w"], dict)) \
                    or "vq" in node:
                key = path[-1] if path else ""
                if key in _REPLICATE_KEYS:
                    return _replicated(node)
                shard_expert = "experts" in path
                if shard_expert:
                    # the expert axis only when it divides the mesh
                    leaf = node["w"] if "w" in node else node["vq"].idx
                    E = leaf.shape[1] if leaf.ndim >= 4 else 0
                    if E % max(mdim, 1) != 0:
                        shard_expert = False
                return _linear_specs(node, axes, row=path[-1] in _ROW_KEYS,
                                     shard_expert=shard_expert)
            out = {}
            for k, v in node.items():
                if k == "emb":
                    out[k] = _pad_front((ma, None), v.ndim)  # vocab-sharded
                elif k == "cw":
                    out[k] = _pad_front((ma,), v.ndim)  # depthwise on d_rnn
                elif k in _REPLICATE_KEYS and _leaf(v):
                    out[k] = _none(v.ndim)
                elif isinstance(v, dict):
                    out[k] = (_replicated(v) if k in _REPLICATE_KEYS
                              else walk(v, path + (k,)))
                elif _leaf(v):
                    out[k] = _none(v.ndim)          # norms, gates, lam
                else:
                    out[k] = v
            return out
        if _leaf(node):
            return _none(node.ndim)
        return node

    return walk(stacked_shapes(params), ())


def _map_specs(fn, specs: Any, shapes: Any) -> Any:
    """``fn(spec, shape)`` at every spec of ``specs`` (a VQWeight's three
    included), beside the stacked shape at the same place."""
    if is_vq(specs):
        return dataclasses.replace(
            specs, **{f: fn(getattr(specs, f), getattr(shapes, f))
                      for f in ("idx", "codebooks", "scale")})
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, shapes[k]) for k, v in specs.items()}
    if isinstance(specs, tuple) and _leaf(shapes):
        return fn(specs, shapes)
    return specs


def opt_pspecs(param_specs: Any, params: Any, mesh: MeshLike, *,
               zero1: bool = True) -> Any:
    """Optimizer m/v/master specs: the param spec plus ZeRO-1 sharding of
    the leading stacked axis over ``data`` where it is unsharded and
    ``data`` divides it (leaves of 3 or more stacked dims)."""
    axes = mesh_axes(mesh)
    dset = "data" if "data" in axes else None
    ddim = axes[dset] if dset else 1

    def one(spec, p):
        if not zero1 or dset is None or p.ndim < 3:
            return spec
        parts = list(spec) + [None] * (p.ndim - len(spec))
        if parts[0] is None and p.shape[0] % ddim == 0:
            parts[0] = dset
            return P(*parts)
        return spec

    return _map_specs(one, param_specs, stacked_shapes(params))


def batch_pspecs(batch: Any, mesh: MeshLike) -> Any:
    """Shard the batch (leading) axis of every input over the DP axes."""
    axes = mesh_axes(mesh)
    dp = _dp_axes(axes)
    total = int(np.prod([axes[a] for a in dp])) if dp else 1

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if x.ndim == 0:
            return P()
        if dp and x.shape[0] % total == 0:
            return P(dp, *([None] * (x.ndim - 1)))
        if "data" in axes and x.shape[0] % axes["data"] == 0:
            return P("data", *([None] * (x.ndim - 1)))
        return _none(x.ndim)

    return one(batch)


_CACHE_TIME_KEYS = {"k", "v", "k_s", "v_s", "latent", "k_rope",
                    "xk", "xv", "cross_k", "cross_v"}


def cache_pspecs(cache: Any, mesh: MeshLike) -> Any:
    """Decode-cache sharding (the port's caches are stacked as the
    reference's): batch over the DP axes when divisible; an unshardable
    batch (long-context B = 1) shards the time axis over every axis
    (sequence-parallel decode); heads or features over ``model`` when
    divisible. A paged node's arenas and block table are replicated."""
    axes = mesh_axes(mesh)
    ma = _model_axis(axes)
    mdim = _dim(axes, ma)
    dp = _dp_axes(axes)
    dp_total = int(np.prod([axes[a] for a in dp])) if dp else 1
    ddim = axes.get("data", 1)

    def leaf_spec(key, x):
        nd = x.ndim
        parts = [None] * nd
        if nd >= 2:
            B = x.shape[1]
            if dp and B % dp_total == 0 and B > 1:
                parts[1] = dp
            elif "data" in axes and B % ddim == 0 and B > 1:
                parts[1] = "data"
        if key in _CACHE_TIME_KEYS and nd >= 3:
            S = x.shape[2]
            if parts[1] is None:
                full = tuple(dp) + ((ma,) if ma else ())
                fdim = dp_total * mdim
                if S >= 1024 and full and S % fdim == 0:
                    parts[2] = full
                elif ma and S >= 1024 and S % mdim == 0:
                    parts[2] = ma
            elif ma and S >= 1024 and S % mdim == 0:
                parts[2] = ma
        elif nd >= 3 and ma and x.shape[-1] % mdim == 0 and key != "len":
            parts[-1] = ma          # recurrent states: shard feature dim
        return P(*parts)

    def walk(node, key=""):
        if isinstance(node, dict):
            if "block_table" in node:
                # a paged node: arena axis 1 is the block pool, which the
                # table indexes globally; only ``len`` keeps the batch rule
                return {k: (leaf_spec(k, v) if k == "len" else _none(v.ndim))
                        for k, v in node.items()}
            return {k: walk(v, k) for k, v in node.items()}
        if _leaf(node):
            return leaf_spec(key, node)
        return node

    return walk(cache)


def zero1_owners(params: Any, mesh: MeshLike) -> Any:
    """The data rank that owns each leaf's optimizer state under ZeRO-1,
    in the port's layout (per-layer lists): layer i of a segment whose
    stacked spec shards L over ``data`` belongs to data rank
    i // (L / |data|); every other leaf is replicated (None). A
    VQWeight's tensors carry no optimizer state (None)."""
    axes = mesh_axes(mesh)
    ddim = axes.get("data", 1)
    ospec = opt_pspecs(param_pspecs(params, mesh), params, mesh)

    def owners(node, spec, layer, L):
        if is_vq(node) or node is None:
            return None
        if isinstance(node, dict):
            return {k: (seg(v, spec[k]) if k in _STACKED
                        and isinstance(v, list) else
                        owners(v, spec[k], layer, L))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(owners(v, s, layer, L)
                              for v, s in zip(node, spec))
        if layer is not None and spec and spec[0] == "data":
            return layer // (L // ddim)
        return None

    def seg(layers, spec):
        return [owners(lp, spec, i, len(layers))
                for i, lp in enumerate(layers)]

    return owners(params, ospec, None, 0)


def to_placements(spec: Spec, mesh: Any) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh`` (a
    ``DeviceMesh``): for each mesh dim, ``Shard(d)`` where the spec's
    dim d names it, else ``Replicate()``.

    Raises:
      ValueError: a mesh dim that shards two tensor dims."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, part in enumerate(spec):
        names = part if isinstance(part, tuple) else (part,)
        for name in names:
            if name is None:
                continue
            i = mesh.mesh_dim_names.index(name)
            if isinstance(out[i], Shard):
                raise ValueError(f"mesh dim {name!r} shards two dims of "
                                 f"{spec}")
            out[i] = Shard(d)
    return out
