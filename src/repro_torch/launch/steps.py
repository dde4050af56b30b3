"""Step builders shared by the training and serving drivers and the
multi-pod dry run (``repro/launch/steps.py``): the train step (loss,
gradients, the schedule and AdamW; data-parallel over a mesh's
``("pod", "data")`` ranks with ZeRO-1 optimizer state, tensor-parallel
over its ``model`` ranks), its sharding specs, the prefill, decode and
serving decode steps with their meta-device specs, and the four
``lower_*`` builders of the dry run.

Sharded execution (``mesh`` given): each rank computes the loss and
gradients of its own shard of the global batch; with ``model`` > 1 every
param is a DTensor on the ``model`` sub-mesh, placed by its spec
(``runtime/tensor_parallel.py``), and the model's code runs on those
shards. The gradients (and the loss) are mean all-reduced over the ranks
that share this rank's ``model`` coordinate, and each rank updates only
the leaves whose optimizer state it owns under ZeRO-1
(``runtime.sharding.zero1_owners``: blocks of layers a data rank; the
other leaves are replicated and updated by every rank alike), then
broadcasts them to the rest of its ``data`` group. A rank holds no
``m``, ``v`` or ``master`` for a leaf another rank owns (an empty
tensor), and of its own leaves only its ``model`` shard;
``DataParallel.gather_opt`` rebuilds the whole state and
``DataParallel.full_params`` the whole params, for a checkpoint.

A "lower" in the port (``lower_train_step`` and the three serving
ones) builds the step with the mesh's shardings and runs it once on
meta tensors under ``roofline.counting.StepCounter``, on a process group
of the mesh's size (the dry run's is a fake one): per-device FLOPs,
collective wire bytes and argument / output / temp bytes, where the
reference lowers an XLA program and reads its HLO.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.models.api import Model
from repro_torch.models.common import RunConfig
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,
                                     adamw_update, float_leaves,
                                     map_leaves, tree_flatten,
                                     tree_unflatten)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import tensor_parallel as tp


# ---------------------------------------------------------------- training


class DataParallel:
    """A ``DeviceMesh``'s ranks for the train step: its data-parallel
    ranks (axes ``("pod", "data")``: this rank's shard of the batch, the
    gradient all-reduce, the ZeRO-1 ownership of the optimizer state)
    and, where ``model`` is larger than 1, its tensor-parallel ranks (the
    params as DTensors on the ``model`` sub-mesh). Every rank of the mesh
    constructs it at the same time (it creates process groups)."""

    def __init__(self, mesh: Any):
        axes = shd.mesh_axes(mesh)
        self.mesh, self.axes = mesh, axes
        names = mesh.mesh_dim_names
        coord = {n: mesh.get_local_rank(n) for n in names}
        self.size = axes.get("pod", 1) * axes.get("data", 1)
        # the reference's batch spec ("pod", "data"): pod-major shards
        self.rank = coord.get("pod", 0) * axes.get("data", 1) \
            + coord.get("data", 0)
        self.data_rank = coord.get("data", 0)
        self.tp = tp.model_mesh(mesh)
        # the data-parallel group: the ranks of this rank's model column
        grid = mesh.mesh
        if "model" in names:
            grid = grid.movedim(names.index("model"), -1)
            cols = [grid[..., j].flatten().tolist()
                    for j in range(grid.shape[-1])]
        else:
            cols = [grid.flatten().tolist()]
        for j, ranks in enumerate(cols):
            g = dist.new_group(sorted(ranks))
            if j == coord.get("model", 0):
                self.group = g
        self.data_group = mesh.get_group("data") if "data" in names else None
        self._owners: Optional[list] = None
        self._specs: Any = None

    def specs(self, params: Any) -> Any:
        """Each tensor's spec in the port's layout, computed once."""
        if self._specs is None:
            self._specs = tp.port_specs(params, self.mesh)
        return self._specs

    def owners(self, params: Any) -> list:
        """The ZeRO-1 owner of each leaf of ``params`` (``tree_flatten``
        order; None: replicated), computed once."""
        if self._owners is None:
            self._owners = tree_flatten(shd.zero1_owners(params,
                                                         self.axes))[0]
        return self._owners

    def mine(self, owner: Optional[int]) -> bool:
        return owner is None or owner == self.data_rank

    def shard_params(self, params: Any) -> Any:
        """Whole ``params`` (the same on every rank) as this rank holds
        them: DTensors on the ``model`` sub-mesh, or as they are when
        ``model`` is 1."""
        if self.tp is None:
            return params
        return tp.distribute(params, self.mesh, self.specs(params))

    def full_params(self, params: Any) -> Any:
        """The whole params on every rank (a collective over ``model``)."""
        return params if self.tp is None else tp.full(params)

    def mean(self, tree: Any) -> Any:
        """The mean over the data-parallel ranks of every float leaf."""
        def one(t):
            t = t.clone()
            dist.all_reduce(t, group=self.group)
            return t / self.size
        return map_leaves(one, tree)

    def global_norm(self, grads: Any, params: Any) -> torch.Tensor:
        """The global norm of the gradients whose ``model`` shards this
        rank holds: the sharded leaves' squares summed over ``model``."""
        sums = {True: [], False: []}
        map_leaves(lambda g, p: sums[tp.sharded(p)].append(
            torch.sum(torch.square(g.float()))), grads, params)
        dev = next(iter(sums[True] + sums[False])).device
        total = lambda xs: (torch.sum(torch.stack(xs)) if xs else
                            torch.zeros((), dtype=torch.float32, device=dev))
        part = total(sums[True])
        if self.tp is not None:
            dist.all_reduce(part, group=self.tp.get_group())
        return torch.sqrt(part + total(sums[False]))

    def shard_opt(self, params: Any, opt: AdamWState) -> AdamWState:
        """``opt`` (whole) as this rank holds it: an empty tensor in place
        of every leaf another rank owns, its own leaves' ``model``
        shards."""
        own = self.owners(params)
        specs = tp.flat_specs(self.specs(params), params)
        shard = ((lambda x, i: x) if self.tp is None else
                 (lambda x, i: tp.local_shard(x, specs[i], self.mesh)))

        def cut(tree):
            if tree is None:
                return None
            flat, tdef = tree_flatten(tree)
            return tree_unflatten(tdef, [
                x if x is None else shard(x, i) if self.mine(o)
                else x.new_empty(0)
                for i, (x, o) in enumerate(zip(flat, own))])

        return opt._replace(m=cut(opt.m), v=cut(opt.v),
                            master=cut(opt.master))

    def _broadcast(self, flat: list, own: list, shapes: list) -> list:
        out = []
        for x, o, like in zip(flat, own, shapes):
            if x is None or o is None:
                out.append(x)
                continue
            if o != self.data_rank:
                x = torch.empty(like.shape, dtype=x.dtype, device=like.device)
            dist.broadcast(x, src=dist.get_global_rank(self.data_group, o),
                           group=self.data_group)
            out.append(x)
        return out

    def broadcast_params(self, params: Any) -> Any:
        """Every owned leaf of ``params`` (this rank's shards) from its
        owner (a new tensor on the other ranks, never written into the
        one given)."""
        flat, tdef = tree_flatten(params)
        if self.data_group is None:
            return params
        got = self._broadcast([x if isinstance(x, torch.Tensor) else None
                               for x in flat], self.owners(params), flat)
        return tree_unflatten(tdef, [g if g is not None else x
                                     for g, x in zip(got, flat)])

    def gather_opt(self, params: Any, opt: AdamWState) -> AdamWState:
        """The whole optimizer state on every rank (each leaf's m, v and
        master from its owner, its ``model`` shards joined), as a
        checkpoint holds it."""
        own = self.owners(params)
        local = tree_flatten(tp.to_local(params))[0]
        placed = tree_flatten(params)[0]

        def whole(tree):
            if tree is None:
                return None
            flat, tdef = tree_flatten(tree)
            if self.data_group is not None:
                flat = self._broadcast(flat, own, local)
            if self.tp is not None:
                flat = [x if x is None else
                        tp.full(tp.from_local(x, p)) for x, p in
                        zip(flat, placed)]
            return tree_unflatten(tdef, flat)

        return opt._replace(m=whole(opt.m), v=whole(opt.v),
                            master=whole(opt.master))


def value_and_grad(model: Model, params: Any, batch: Any, rc: RunConfig):
    """(loss, gradient tree) of ``model.loss(params, batch, rc)`` by
    autograd: every floating-point leaf of ``params`` differentiated, the
    others passed as they are."""
    live = [x.detach().requires_grad_(True) for x in float_leaves(params)]
    flat, tdef = tree_flatten(params)
    it = iter(live)
    p = tree_unflatten(tdef, [next(it) if isinstance(x, torch.Tensor)
                              and x.is_floating_point() else x
                              for x in flat])
    loss = model.loss(p, batch, rc)
    it = iter(torch.autograd.grad(loss, live))
    return loss.detach(), map_leaves(lambda x: next(it), params)


def _local_grads(loss, grads, params):
    """A sharded step's loss and gradients as this rank's plain tensors:
    each gradient placed as its param (a partial sum reduced over
    ``model``), then its shard."""
    from torch.distributed.tensor import DTensor

    def one(g, p):
        if isinstance(g, DTensor):
            g = g.redistribute(p.device_mesh, p.placements).to_local()
        return g

    if isinstance(loss, DTensor):
        loss = loss.full_tensor()
    return loss, map_leaves(one, grads, params)


def make_train_step(model: Model, opt_cfg: AdamWConfig, rc: RunConfig, *,
                    total_steps: int = 100000, warmup: int = 1000,
                    accum_steps: int = 1, mesh: Any = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "gnorm", "lr_scale"})``: the mean loss of ``batch`` and its
    gradients (``accum_steps > 1``: the batch split into that many
    microbatches, their losses and gradients summed in order, then
    divided), the ``warmup_cosine`` multiplier at ``opt_state.step``,
    then ``adamw_update``. New tensors throughout: the step before stays
    as it was. With ``mesh`` (a ``DeviceMesh``) the step is sharded
    (module docstring): ``batch`` is this rank's shard, ``params`` as
    ``train_step.dp.shard_params`` places them and ``opt_state`` as
    ``train_step.dp.shard_opt`` cuts it."""
    dp = DataParallel(mesh) if mesh is not None else None
    sharded = dp is not None and dp.tp is not None

    def grads_of(params, batch):
        region = tp.tp_region() if sharded else contextlib.nullcontext()
        with region:
            loss, grads = value_and_grad(model, params, batch, rc)
            if sharded:
                loss, grads = _local_grads(loss, grads, params)
        return loss, grads

    def train_step(params, opt_state: AdamWState, batch):
        if accum_steps == 1:
            loss, grads = grads_of(params, batch)
        else:
            split = lambda x: x.reshape(accum_steps, x.shape[0] // accum_steps,
                                        *x.shape[1:])
            micro = {k: split(v) for k, v in batch.items()}
            loss, grads = None, None
            for i in range(accum_steps):
                l, g = grads_of(params, {k: v[i] for k, v in micro.items()})
                if loss is None:  # fp32 sums, whatever the params' dtype
                    loss, grads = l.float(), map_leaves(torch.Tensor.float, g)
                else:
                    loss = loss + l
                    grads = map_leaves(torch.add, grads, g)
            loss = loss / accum_steps
            grads = map_leaves(lambda g: g / accum_steps, grads)
        lr_scale = warmup_cosine(opt_state.step, warmup_steps=warmup,
                                 total_steps=total_steps)
        if dp is None:
            new_params, new_opt, gnorm = adamw_update(
                grads, opt_state, params, opt_cfg, lr_scale)
        else:
            grads, loss = dp.mean(grads), dp.mean(loss)
            # the clip needs every leaf; each rank then updates its own
            gnorm = dp.global_norm(grads, params)
            if opt_cfg.grad_clip > 0:
                scale = torch.clamp(opt_cfg.grad_clip
                                    / torch.clamp(gnorm, min=1e-12), max=1.0)
                grads = map_leaves(lambda g: g * scale.to(g.dtype), grads)
            flat, tdef = tree_flatten(grads)
            grads = tree_unflatten(tdef, [
                g if dp.mine(o) else None
                for g, o in zip(flat, dp.owners(params))])
            new_params, new_opt, _ = adamw_update(
                grads, opt_state, tp.to_local(params),
                dataclasses.replace(opt_cfg, grad_clip=0.0), lr_scale)
            new_params = dp.broadcast_params(new_params)
            if sharded:
                new_params = tp.from_local(new_params, params)
        metrics = {"loss": loss, "gnorm": gnorm,
                   "lr_scale": torch.as_tensor(lr_scale, dtype=torch.float32)}
        return new_params, new_opt, metrics

    train_step.dp = dp
    return train_step


def train_shardings(model: Model, mesh: Any, params: Any,
                    opt_state: AdamWState, batch: Any):
    """((param, opt, batch) specs, (param, opt, metrics) specs) in the
    stacked layout, as the reference's ``train_shardings``."""
    pspec = shd.param_pspecs(params, mesh)
    mspec = shd.opt_pspecs(pspec, params, mesh, zero1=True)
    opt_spec = AdamWState(step=shd.P(), m=mspec, v=mspec,
                          master=(mspec if opt_state.master is not None
                                  else None))
    bspec = shd.batch_pspecs(batch, mesh)
    metr_spec = {"loss": shd.P(), "gnorm": shd.P(), "lr_scale": shd.P()}
    return (pspec, opt_spec, bspec), (pspec, opt_spec, metr_spec)


# ----------------------------------------------------------------- serving


def make_prefill_step(model: Model, rc: RunConfig):
    def prefill_step(params, batch):
        logits, caches = model.forward(params, batch,
                                       rc.replace(mode="prefill"))
        return logits[:, -1:], caches

    return prefill_step


def make_decode_step(model: Model, rc: RunConfig):
    def decode_step(params, tokens, positions, caches):
        return model.decode(params, tokens, positions, caches,
                            rc.replace(mode="decode"))

    return decode_step


def make_serve_decode_step(model: Model, rc: RunConfig):
    """The serving decode step: the model's decode and the per-slot
    sampling and stopping epilogue (``serve.api.sample_and_stop``), the
    logits never leaving the device; returns (next_tok, done, bad,
    caches). The port samples with one ``torch.Generator`` a slot where
    the reference carries PRNG keys."""
    from repro_torch.serve import api as serve_api

    def serve_decode_step(params, caches, tokens, positions, generators,
                          temperature, top_k, top_p, greedy, stop_ids,
                          remaining, active, poison):
        logits, new_caches = model.decode(
            params, tokens[:, None], positions[:, None], caches,
            rc.replace(mode="decode"))
        logits = logits[:, 0, :model.cfg.vocab_size] + poison[:, None]
        tok, done, bad = serve_api.sample_and_stop(
            logits, generators=generators, temperature=temperature,
            top_k=top_k, top_p=top_p, greedy=greedy, stop_ids=stop_ids,
            remaining=remaining, active=active)
        return tok, done, bad, new_caches

    return serve_decode_step


def serve_cache_specs(model: Model, num_slots: int, max_len: int, *,
                      paged: bool = False, block_size: int = 16,
                      num_blocks: Optional[int] = None) -> Any:
    """The serving cache on the meta device: contiguous, or the paged
    layout (block arenas and per-slot block tables, ``serve/paging.py``)."""
    if not paged:
        return model.cache_specs(num_slots, max_len)
    from repro_torch.serve import paging

    cfg = model.cfg
    meta = paging.make_paging_config(
        model, num_slots, max_len, window=cfg.sliding_window
        or cfg.local_window, block_size=block_size, num_blocks=num_blocks)
    return paging.init_paged_cache(model, num_slots, max_len, meta,
                                   device="meta")


def serve_state_specs(batch: int) -> Dict[str, torch.Tensor]:
    """The engine's per-slot sampling and stopping state on the meta
    device (the tensor inputs of ``make_serve_decode_step``; the
    generators and the greedy flags are host values)."""
    from repro_torch.serve import api as serve_api

    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    return {"tokens": meta((batch,), torch.int32),
            "positions": meta((batch,), torch.int32),
            "temperature": meta((batch,), torch.float32),
            "top_k": meta((batch,), torch.int32),
            "top_p": meta((batch,), torch.float32),
            "stop_ids": meta((batch, serve_api.MAX_STOP_IDS), torch.int32),
            "remaining": meta((batch,), torch.int32),
            "active": meta((batch,), torch.bool),
            "poison": meta((batch,), torch.float32)}


# ---------------------------------------------------------------- lowering


@dataclasses.dataclass
class Lowered:
    """One run of a step over meta tensors on one rank of a mesh,
    counted: the port's counterpart of a lowered XLA program. ``costs``
    is a ``roofline.counting.StepCosts``; ``replicated_ops`` the ops
    DTensor had no rule for (``tensor_parallel.ReplicateFallback``)."""
    kind: str
    costs: Any
    replicated_ops: Dict[str, int]
    cache_bytes: float = 0.0


def _local_input(x: torch.Tensor, spec: Any, mesh: Any) -> Any:
    """This rank's part of a whole (meta) input placed by ``spec``: each
    dim split by the data-parallel axes it names (a plain tensor of the
    local size), then sharded over ``model`` where it names that too (a
    DTensor on the ``model`` sub-mesh)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    axes = shd.mesh_axes(mesh)
    shape, on_model = list(x.shape), None
    for d, part in enumerate(spec):
        for name in (part if isinstance(part, tuple) else (part,)):
            if name == "model":
                on_model = d
            elif name is not None:
                shape[d] //= axes[name]
    local = torch.empty(shape, dtype=x.dtype, device=x.device)
    mm = tp.model_mesh(mesh)
    if on_model is None or mm is None:
        return local
    return distribute_tensor(local, mm, [Shard(on_model)], src_data_rank=None)


def _place_inputs(tree: Any, specs: Any, mesh: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _place_inputs(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _local_input(tree, specs, mesh)
    return tree


def _place_params(params: Any, mesh: Any) -> Any:
    if tp.model_mesh(mesh) is None:
        return params
    return tp.distribute(params, mesh, tp.port_specs(params, mesh))


def _count(kind: str, run, inputs: Any, sharded: bool,
           cache: Any = None) -> Lowered:
    from repro_torch.roofline.counting import StepCounter

    counter = StepCounter()
    counter.arguments(inputs)
    fb = tp.ReplicateFallback()
    region = tp.tp_region(fb) if sharded else contextlib.nullcontext()
    with torch.no_grad() if kind != "train" else contextlib.nullcontext():
        with counter, region:
            out = run()
    cache_bytes = 0.0
    if cache is not None:
        cache_bytes = float(sum(
            t.numel() * t.element_size()
            for t in tree_flatten(tp.to_local(cache))[0]
            if isinstance(t, torch.Tensor)))
    return Lowered(kind=kind, costs=counter.finish(out),
                   replicated_ops=dict(fb.ops), cache_bytes=cache_bytes)


def lower_train_step(model: Model, mesh: Any, specs: Dict[str, Any],
                     rc: Optional[RunConfig] = None,
                     opt_cfg: Optional[AdamWConfig] = None) -> Lowered:
    """The sharded train step built on ``mesh`` and run once over meta
    params, optimizer state and batch (``model.input_specs``), counted."""
    from repro_torch.optim.adamw import adamw_init

    rc = rc or RunConfig(mode="train", remat=True)
    opt_cfg = opt_cfg or AdamWConfig()
    step = make_train_step(model, opt_cfg, rc, mesh=mesh)
    dp = step.dp
    whole = model.param_specs()
    params = dp.shard_params(whole)
    opt = dp.shard_opt(whole, adamw_init(whole, opt_cfg))
    batch = _place_inputs(specs, shd.batch_pspecs(specs, mesh), mesh)
    # the step enters the tensor-parallel region itself
    return _count("train", lambda: step(params, opt, batch),
                  (params, opt, batch), sharded=False)


def lower_prefill_step(model: Model, mesh: Any, specs: Dict[str, Any],
                       rc: Optional[RunConfig] = None, *,
                       quantized: bool = True) -> Lowered:
    from repro_torch.core.plan import PlanPolicy

    rc = rc or RunConfig(mode="prefill", remat=False,
                         plan_policy=PlanPolicy(int8_prefill=True,
                                                impl="torch"))
    params = _place_params(model.param_specs(quantized=quantized), mesh)
    batch = _place_inputs(specs, shd.batch_pspecs(specs, mesh), mesh)
    step = make_prefill_step(model, rc)
    return _count("prefill", lambda: step(params, batch), (params, batch),
                  sharded=tp.model_mesh(mesh) is not None)


def _decode_rc(rc: Optional[RunConfig], quantized: bool,
               vq_mode: str) -> RunConfig:
    from repro_torch.core.plan import PlanPolicy

    rc = rc or RunConfig(mode="decode", remat=False,
                         plan_policy=PlanPolicy(vq_mode=vq_mode,
                                                impl="torch"))
    return rc.replace_policy(vq_mode=vq_mode if quantized else "none")


def lower_decode_step(model: Model, mesh: Any, specs: Dict[str, Any],
                      rc: Optional[RunConfig] = None, *,
                      quantized: bool = True,
                      vq_mode: str = "eva") -> Lowered:
    """specs: {"tokens", "positions", "caches"} from model.input_specs.
    The cache is updated in place, as the engine's is."""
    rc = _decode_rc(rc, quantized, vq_mode)
    params = _place_params(model.param_specs(quantized=quantized), mesh)
    caches = _place_inputs(specs["caches"],
                           shd.cache_pspecs(specs["caches"], mesh), mesh)
    tok = {k: specs[k] for k in ("tokens", "positions")}
    tok = _place_inputs(tok, shd.batch_pspecs(tok, mesh), mesh)
    step = make_decode_step(model, rc)
    return _count("decode", lambda: step(params, tok["tokens"],
                                         tok["positions"], caches),
                  (params, tok, caches),
                  sharded=tp.model_mesh(mesh) is not None, cache=caches)


def lower_serve_decode_step(model: Model, mesh: Any, specs: Dict[str, Any],
                            rc: Optional[RunConfig] = None, *,
                            quantized: bool = True,
                            vq_mode: str = "eva") -> Lowered:
    """The full serving decode step (decode, then the sampling and
    stopping epilogue). It runs greedy: the port draws sampled tokens
    from per-slot ``torch.Generator``s, which have no meta counterpart,
    and a greedy lane reads none. Its per-slot state is split over the
    data-parallel ranks with the cache's batch (the reference replicates
    those few bytes)."""
    rc = _decode_rc(rc, quantized, vq_mode)
    params = _place_params(model.param_specs(quantized=quantized), mesh)
    caches = _place_inputs(specs["caches"],
                           shd.cache_pspecs(specs["caches"], mesh), mesh)
    gb = int(specs["tokens"].shape[0])
    state = serve_state_specs(gb)
    state = _place_inputs(state, shd.batch_pspecs(state, mesh), mesh)
    b = int(state["tokens"].shape[0])
    step = make_serve_decode_step(model, rc)
    order = ("tokens", "positions")
    return _count(
        "decode",
        lambda: step(params, caches, *[state[k] for k in order],
                     [None] * b, state["temperature"], state["top_k"],
                     state["top_p"], [True] * b, state["stop_ids"],
                     state["remaining"], state["active"], state["poison"]),
        (params, caches, state), sharded=tp.model_mesh(mesh) is not None,
        cache=caches)
