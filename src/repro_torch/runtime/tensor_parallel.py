"""Tensor parallelism over a mesh's ``model`` axis: the counterpart of
the reference's GSPMD execution of a sharded step.

Every param is a ``DTensor`` on the mesh's one-dimensional ``model``
sub-mesh, placed by its spec (``sharding.param_pspecs``, the
reference's rules and fallbacks: column- or row-parallel linears, the
V-sharded contraction of a misaligned grouped family, experts over
``model`` where E divides it, the vocab-sharded ``emb``, ``cw`` on
d_rnn). The model's plain torch code then runs on them inside
``tp_region()``: DTensor's sharding rules place each op's output and
insert the collectives (the all-reduce after a row-parallel product, a
gather where a sharded dim is reshaped across its shards). The
data-parallel axes (``pod``, ``data``) stay outside DTensor: each rank
holds its shard of the batch as a plain tensor, which the region treats
as replicated over ``model`` (``implicit_replication``), and the
gradients are averaged by ``launch.steps.DataParallel``.

Five parts of the model run on local shards with explicit collectives
instead, because DTensor has no rule for them that keeps the shards:

  * ``vocab_parallel_embed``: the lookup in a vocab-sharded ``emb`` (each
    rank its rows, the sum over ``model``; DTensor would gather the
    table);
  * ``vocab_parallel_cross_entropy``: the loss over a vocab-sharded head
    (a max and two sums all-reduced over ``model``; DTensor's gather
    over a sharded vocab does not reduce its masked partial);
  * ``vq_linear``: a VQ weight's indices and scales sharded on N
    (column-parallel: x replicated, the output sharded) or on V (the
    contraction: x sharded on K, the output a partial sum); DTensor
    would gather the indices to look them up;
  * ``by_heads``: attention (``models.common.blocked_attention``) on this
    rank's heads; DTensor gathers the score matrices in the backward;
  * ``sp_decode_attention``: decode attention over a cache whose time
    axis is sharded (sequence-parallel decode, ``cache_pspecs``): each
    rank writes the new row if its slot is local, attends its rows, and
    the ranks merge their (max, sum, output) partials.

Any other op DTensor has no rule for, or whose rule fails on the shards
it chose, runs through ``ReplicateFallback``: its DTensor arguments are
gathered whole, the op runs on every rank alike, and an in-place result
is sliced back into the shard. ``ReplicateFallback.ops`` names the ops
that took it; the dry run records them a cell (``replicated_ops``). Over
every cell of the production meshes these are ``aten.index_put_`` (a
cache written along a sharded time axis: MLA's latent in deepseek's
prefill and decode, mixtral's ring in prefill), ``aten.copy_`` (xLSTM's
recurrent state written back across placements) and ``aten.view`` (a
view across a sharded dim in xLSTM's and vision's prefill and decode).
No train step takes it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.convert import _STACKED, is_vq
from repro_torch.runtime import sharding as shd


def _dt():
    from torch.distributed import tensor as dt

    return dt


def is_dtensor(x: Any) -> bool:
    if is_vq(x):
        x = x.idx
    return isinstance(x, _dt().DTensor)


def model_mesh(mesh: Any) -> Any:
    """The one-dimensional ``model`` sub-mesh of a ``DeviceMesh`` whose
    ``model`` axis is larger than 1 (None otherwise)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    return mesh["model"] if mesh.size(mesh.mesh_dim_names.index("model")) > 1 \
        else None


def model_placement(spec: shd.Spec, mesh: Any) -> list:
    """The placement on the full ``mesh`` of ``spec`` restricted to its
    ``model`` dim: [Shard(d)] or [Replicate()]."""
    full = shd.to_placements(spec, mesh)
    return [full[mesh.mesh_dim_names.index("model")]]


def port_specs(params: Any, mesh: Any, specs: Any = None) -> Any:
    """The spec of every tensor of ``params`` in the port's layout: a
    stacked segment's spec (L first) given to each of its per-layer
    dicts with the L entry dropped (``sharding.param_pspecs`` when
    ``specs`` is None)."""
    specs = shd.param_pspecs(params, mesh) if specs is None else specs

    def walk(node, spec, drop):
        if is_vq(node):
            return dataclasses.replace(
                spec, **{f: tuple(getattr(spec, f))[drop:]
                         for f in ("idx", "codebooks", "scale")})
        if isinstance(node, dict):
            return {k: ([walk(lp, spec[k], drop + 1) for lp in v]
                        if k in _STACKED and isinstance(v, list)
                        else walk(v, spec[k], drop))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, s, drop) for v, s in zip(node, spec))
        if isinstance(node, torch.Tensor):
            return tuple(spec)[drop:]
        return spec

    return walk(params, specs, 0)


def flat_specs(specs: Any, params: Any) -> list:
    """The nodes of ``specs`` (``port_specs`` layout) at the leaves of
    ``params`` in ``optim.tree_flatten`` order (a tensor's spec tuple, a
    VQWeight of specs), where ``tree_flatten(specs)`` would split each
    spec into its entries."""
    out: list = []

    def walk(node, spec):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], spec[k])
        elif isinstance(node, (list, tuple)):
            for v, sp in zip(node, spec):
                walk(v, sp)
        else:
            out.append(spec)

    walk(params, specs)
    return out


def map_tensors(fn, tree: Any, *rest: Any) -> Any:
    """``fn(tensor, *others)`` at every tensor of ``tree`` (a VQWeight's
    three included), the nodes at the same place in ``rest`` beside it."""
    if is_vq(tree):
        return dataclasses.replace(tree, **{
            f: fn(getattr(tree, f), *[getattr(r, f) for r in rest])
            for f in ("idx", "codebooks", "scale")})
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tensors(fn, v, *[r[i] for r in rest])
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree


def distribute(tree: Any, mesh: Any, specs: Any) -> Any:
    """``tree`` (whole tensors, the same on every rank) as DTensors on
    ``mesh``'s ``model`` sub-mesh, each placed by its spec in ``specs``
    (``port_specs`` layout). Each rank keeps its own shard; nothing is
    communicated."""
    dt = _dt()
    mm = model_mesh(mesh)

    def one(x, spec):
        return dt.distribute_tensor(x.detach(), mm, model_placement(spec, mesh),
                                    src_data_rank=None)

    return map_tensors(one, tree, specs)


def from_local(tree: Any, like: Any) -> Any:
    """Local shards as DTensors placed as the DTensors of ``like``."""
    dt = _dt()

    def one(x, ref):
        if not isinstance(ref, dt.DTensor):
            return x
        return dt.DTensor.from_local(x, ref.device_mesh, ref.placements,
                                     run_check=False, shape=ref.shape,
                                     stride=ref.stride())

    return map_tensors(one, tree, like)


def to_local(tree: Any) -> Any:
    """Every DTensor of ``tree`` as this rank's shard."""
    dt = _dt()
    return map_tensors(lambda x: x.to_local() if isinstance(x, dt.DTensor)
                       else x, tree)


def full(tree: Any) -> Any:
    """Every DTensor of ``tree`` whole (a collective: every rank of its
    mesh calls it)."""
    dt = _dt()
    return map_tensors(lambda x: x.full_tensor() if isinstance(x, dt.DTensor)
                       else x, tree)


def local_shard(x: torch.Tensor, spec: shd.Spec, mesh: Any) -> torch.Tensor:
    """This rank's ``model`` shard of the whole tensor ``x`` placed by
    ``spec`` on ``mesh`` (no communication)."""
    return _dt().distribute_tensor(x, model_mesh(mesh),
                                   model_placement(spec, mesh),
                                   src_data_rank=None).to_local()


def local_slice(x: torch.Tensor, like: Any) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x``, placed as the DTensor
    ``like`` (no communication)."""
    dt = _dt()
    if not isinstance(like, dt.DTensor):
        return x
    return dt.distribute_tensor(x, like.device_mesh, like.placements,
                                src_data_rank=None).to_local()


def sharded(x: Any) -> bool:
    """Whether a DTensor is split over its mesh (not replicated)."""
    dt = _dt()
    return isinstance(x, dt.DTensor) and any(
        not p.is_replicate() for p in x.placements)


# --------------------------------------------------------------- fallback


def _replicate(x):
    dt = _dt()
    if isinstance(x, dt.DTensor):
        return x.redistribute(x.device_mesh,
                              [dt.Replicate()] * x.device_mesh.ndim)
    return x


class ReplicateFallback(TorchDispatchMode):
    """Runs every op DTensor has no sharding rule for (or whose rule
    fails on the shards it chose) on whole tensors:
    its DTensor arguments are replicated (an all-gather, or the
    all-reduce of a partial sum), the op runs on the local copies, and
    its tensor results come back as replicated DTensors; an in-place op
    on a sharded tensor writes its shard of the result back. ``ops``
    collects the names of the ops that took this path."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dt = _dt()
        if not any(issubclass(t, dt.DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (NotImplementedError, RuntimeError, IndexError,
                AssertionError):
            # no rule, or a rule whose local op fails on its shards (an
            # error of the op itself fails again below, on whole tensors)
            pass
        name = str(func)
        self.ops[name] = self.ops.get(name, 0) + 1
        flat, spec = torch.utils._pytree.tree_flatten((args, kwargs))
        mesh = next(a.device_mesh for a in flat if isinstance(a, dt.DTensor))
        whole = [_replicate(a).to_local() if isinstance(a, dt.DTensor) else a
                 for a in flat]
        a2, k2 = torch.utils._pytree.tree_unflatten(whole, spec)
        out = func(*a2, **k2)
        # an in-place op: its first argument takes back its shard
        first = args[0] if args else None
        if isinstance(first, dt.DTensor) and func._schema.arguments \
                and func._schema.arguments[0].alias_info is not None \
                and func._schema.arguments[0].alias_info.is_write:
            first.to_local().copy_(local_slice(whole[0], first))
            return first
        rep = [dt.Replicate()] * mesh.ndim
        return torch.utils._pytree.tree_map(
            lambda o: dt.DTensor.from_local(o, mesh, rep, run_check=False)
            if isinstance(o, torch.Tensor) else o, out)


@contextlib.contextmanager
def tp_region(fallback: Optional[ReplicateFallback] = None
              ) -> Iterator[ReplicateFallback]:
    """The context a sharded step runs in: plain tensors taken as
    replicated over ``model`` and the replicate fallback on."""
    from torch.distributed.tensor.experimental import implicit_replication

    fb = fallback if fallback is not None else ReplicateFallback()
    with implicit_replication(), fb:
        yield fb


# ------------------------------------------------------ explicit regions


def _group_of(x):
    return x.device_mesh.get_group()


def _coord(x) -> int:
    return x.device_mesh.get_local_rank()


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group, whose gradient is the sum of the ranks'
    gradients (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A differentiable all-reduce (sum) over ``group``."""
    return _AllReduceSum.apply(x, group)


def rows_sharded(table: Any) -> bool:
    """Whether an embedding table (V, D) is a DTensor split on V."""
    dt = _dt()
    return isinstance(table, dt.DTensor) and table.placements[0] \
        == dt.Shard(0)


def vocab_parallel_embed(table: Any, tokens: torch.Tensor) -> Any:
    """``table[tokens]`` for a table split on its rows (the vocab) over
    ``model``: each rank looks up the tokens in its range (zeros for the
    rest), and the result is their sum over ``model``, a partial sum
    that the next op reduces where it needs the whole."""
    dt = _dt()
    local = table.to_local()
    Vl = local.shape[0]
    t = tokens.to_local() if isinstance(tokens, dt.DTensor) else tokens
    rel = t.long() - _coord(table) * Vl
    inr = (rel >= 0) & (rel < Vl)
    rows = local[rel.clamp(0, Vl - 1)] * inr[..., None].to(local.dtype)
    return dt.DTensor.from_local(rows, table.device_mesh, [dt.Partial()],
                                 run_check=False).redistribute(
        table.device_mesh, [dt.Replicate()])


def vocab_sharded(logits: Any) -> bool:
    dt = _dt()
    return isinstance(logits, dt.DTensor) and logits.placements[0] \
        == dt.Shard(logits.ndim - 1)


def vocab_parallel_cross_entropy(logits: Any, labels: torch.Tensor,
                                 mask: Optional[torch.Tensor],
                                 vocab_size: int) -> torch.Tensor:
    """``models.common.cross_entropy_loss`` over logits (B, S, V) that
    are a DTensor on the ``model`` sub-mesh, split on V first where they
    are not (the head of a vocab-sharded ``emb``/``lm_head`` splits them
    already), the padded vocabulary's columns masked out, as
    ``Model.loss`` does: each rank takes its columns' max, sum of
    exponentials and the gold logit where the label falls in its range,
    and the three are reduced over ``model`` (the sums through
    ``all_reduce_sum``, which carries their gradients back). The
    same value on every rank, a plain tensor."""
    dt = _dt()
    if not vocab_sharded(logits):   # a partial sum or a whole: split V
        logits = logits.redistribute(logits.device_mesh,
                                     [dt.Shard(logits.ndim - 1)])
    group = _group_of(logits)
    local = logits.to_local()
    Vl = local.shape[-1]
    lo = _coord(logits) * Vl
    cols = torch.arange(lo, lo + Vl, device=local.device)
    local = torch.where(cols < vocab_size, local,
                        torch.full((), -1e30, dtype=local.dtype,
                                   device=local.device))
    mx = local.detach().amax(dim=-1)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
    se = torch.exp(local - mx[..., None]).sum(dim=-1)
    se = all_reduce_sum(se, group)
    lab = labels.long() - lo
    inr = (lab >= 0) & (lab < Vl)
    gold = torch.gather(local, -1, lab.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = all_reduce_sum(torch.where(inr, gold, torch.zeros_like(gold)),
                          group)
    nll = torch.log(se) + mx - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _local_vq(vq, N: int, K: int):
    idx, cb, sc = (getattr(vq, f).to_local() if is_dtensor(getattr(vq, f))
                   else getattr(vq, f) for f in ("idx", "codebooks", "scale"))
    splits = () if N != vq.N else tuple(vq.splits)
    return dataclasses.replace(vq, idx=idx, codebooks=cb, scale=sc, K=K, N=N,
                               splits=splits)


def vq_linear(x: Any, vq: Any, run) -> Any:
    """A VQ linear whose indices are DTensors, on local shards:
    ``run(x_local, vq_local)`` is the planned matmul on this rank's
    shard. Indices sharded on N (their last dim): x replicated, the
    output sharded on its last dim. Sharded on V (the dim before): x
    sharded on K, the output a partial sum over ``model``. Replicated:
    the whole product on every rank."""
    dt = _dt()
    mesh = vq.idx.device_mesh
    pl = vq.idx.placements[0]
    nd = vq.idx.ndim
    if not isinstance(x, dt.DTensor):
        x = dt.DTensor.from_local(x, mesh, [dt.Replicate()], run_check=False)
    if pl.is_shard() and pl.dim == nd - 1:
        xl = x.redistribute(mesh, [dt.Replicate()]).to_local()
        local = _local_vq(vq, vq.idx.to_local().shape[-1], vq.K)
        y = run(xl, local)
        return dt.DTensor.from_local(y, mesh, [dt.Shard(y.ndim - 1)],
                                     run_check=False)
    if pl.is_shard() and pl.dim == nd - 2:
        xl = x.redistribute(mesh, [dt.Shard(x.ndim - 1)]).to_local()
        local = _local_vq(vq, vq.N, vq.idx.to_local().shape[-2] * vq.d)
        y = run(xl, local)
        return dt.DTensor.from_local(y, mesh, [dt.Partial()],
                                     run_check=False)
    xl = x.redistribute(mesh, [dt.Replicate()]).to_local()
    y = run(xl, _local_vq(vq, vq.N, vq.K))
    return dt.DTensor.from_local(y, mesh, [dt.Replicate()], run_check=False)


def by_heads(fn, q: Any, k: Any, v: Any, **kw) -> Any:
    """Attention ``fn(q, k, v, **kw)`` (q (B, Sq, H, hd), k and v
    (B, Skv, Hk, hd)) on this rank's heads: H / |model| query heads and
    the key/value heads they read (GQA), the output sharded on its heads.
    Heads that do not split evenly run whole on every rank (a replicated
    output). DTensor's own rules would gather the score matrices, whose
    (batch, head) dims a sharded head dim reaches as a strided shard."""
    dt = _dt()
    mesh = next(t.device_mesh for t in (q, k, v)
                if isinstance(t, dt.DTensor))
    m, r = mesh.size(), mesh.get_local_rank()
    whole = lambda t: (t.redistribute(mesh, [dt.Replicate()]).to_local()
                       if isinstance(t, dt.DTensor) else t)
    H, Hk = q.shape[2], k.shape[2]
    g, Hl = H // Hk, H // m
    if H % m or (Hl % g and g % Hl):
        o = fn(whole(q), whole(k), whole(v), **kw)
        return dt.DTensor.from_local(o, mesh, [dt.Replicate()],
                                     run_check=False)
    a = r * Hl
    ka, kb = a // g, a // g + max(Hl // g, 1)

    def heads(t, lo, hi):   # this rank's own shard, or a slice of the whole
        if isinstance(t, dt.DTensor) and t.placements[0] == dt.Shard(2) \
                and t.shape[2] // m == hi - lo:
            return t.to_local()
        return whole(t)[:, :, lo:hi]

    o = fn(heads(q, a, a + Hl), heads(k, ka, kb), heads(v, ka, kb), **kw)
    return dt.DTensor.from_local(o, mesh, [dt.Shard(2)], run_check=False)


def reduce_partial(y: Any) -> Any:
    """A linear's output as Megatron leaves it: a partial sum (a
    row-parallel product) all-reduced to a whole, anything else as it
    is. Without it DTensor may carry the partial sum down the residual
    stream and later split the head's contraction instead."""
    dt = _dt()
    if isinstance(y, dt.DTensor) and any(p.is_partial()
                                         for p in y.placements):
        return y.redistribute(y.device_mesh,
                              [dt.Replicate()] * y.device_mesh.ndim)
    return y


def time_sharded(cache: Dict[str, Any]) -> bool:
    """Whether a decode cache's K leaf is split on its time axis."""
    dt = _dt()
    k = cache.get("k")
    return isinstance(k, dt.DTensor) and any(
        p.is_shard() and p.dim == 1 for p in k.placements)


def sp_decode_attention(q: Any, rows: Dict[str, Any], cache: Dict[str, Any],
                        ring: bool = False) -> Any:
    """One decode token (q (B, 1, H, hd)) against a contiguous fp cache
    whose time axis (dim 1 of k, v (B, S, Hk, hd)) is sharded over
    ``model``: this rank writes ``rows`` at slot ``len`` (``len % S`` in
    a ring, whose slots below ``min(len + 1, S)`` are valid) if that slot
    is one of its own, attends its valid slots, and the ranks merge
    their partial softmaxes (the max, then the rescaled sums and outputs
    all-reduced). ``len`` (B,) advances by one, as in
    ``models.common._decode_contiguous``. Returns o (B, 1, H, hd)
    replicated."""
    dt = _dt()
    k, v = cache["k"], cache["v"]
    mesh = k.device_mesh
    group = mesh.get_group()
    rep = lambda t: (t.redistribute(mesh, [dt.Replicate()]).to_local()
                     if isinstance(t, dt.DTensor) else t)
    ql = rep(q).float()
    kl, vl = k.to_local(), v.to_local()
    B, Sl, Hk, hd = kl.shape
    lo = _coord(k) * Sl
    length = rep(cache["len"]).long()                           # (B,)
    S = Sl * mesh.size()
    if ring:
        slot = length % S - lo
        mine = (slot >= 0) & (slot < Sl)
    else:   # a position past capacity is dropped
        slot = length.clamp(max=S - 1) - lo                     # (B,)
        mine = (slot >= 0) & (slot < Sl) & (length < S)
    b = torch.arange(B, device=kl.device)
    at = slot.clamp(0, Sl - 1)
    for name, buf in (("k", kl), ("v", vl)):
        new = rep(rows[name])[:, 0].to(buf.dtype)               # (B, Hk, hd)
        keep = mine.reshape(B, 1, 1)
        buf[b, at] = torch.where(keep, new, buf[b, at])
    cache["len"].copy_(cache["len"] + 1)
    H = ql.shape[2]
    g = H // Hk
    qg = ql[:, 0].reshape(B, Hk, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kl.float())
    s = s * hd ** -0.5
    pos = lo + torch.arange(Sl, device=kl.device)
    new = (length + 1).clamp(max=S) if ring else length + 1
    valid = pos[None, :] < new[:, None]                         # (B, Sl)
    s = torch.where(valid[:, None, None], s,
                    torch.full((), float("-inf"), device=s.device))
    m = s.amax(dim=-1)
    m_all = m.clone()
    dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m_all[..., None])
    p = torch.where(valid[:, None, None], p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, vl.float())
    dist.all_reduce(l, group=group)
    dist.all_reduce(o, group=group)
    o = (o / l[..., None]).reshape(B, 1, H, hd).to(q.dtype)
    return dt.DTensor.from_local(o, mesh, [dt.Replicate()], run_check=False)
