"""Step builders shared by the training and serving drivers
(``repro/launch/steps.py``): the train step (loss, gradients, the
schedule and AdamW; data-parallel over a mesh's ``("pod", "data")``
ranks with ZeRO-1 optimizer state), its sharding specs, and the
prefill, decode and serving decode steps with their meta-device specs.

Data-parallel execution (``mesh`` given): each rank computes the loss
and gradients of its own shard of the global batch, the gradients (and
the loss) are mean all-reduced over the data-parallel group, and each
rank updates only the leaves whose optimizer state it owns under ZeRO-1
(``runtime.sharding.zero1_owners``: blocks of layers a data rank; the
other leaves are replicated and updated by every rank alike), then
broadcasts them to the rest of its ``data`` group. A rank holds no
``m``, ``v`` or ``master`` for a leaf another rank owns (an empty
tensor); ``DataParallel.gather_opt`` rebuilds the whole state, for a
checkpoint. Tensor parallelism over ``model`` is not ported (ROADMAP
A10): a mesh whose ``model`` axis is larger than 1 raises.

The reference's ``lower_*`` functions lower XLA programs for the
multi-pod dry run, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.models.api import Model
from repro_torch.models.common import RunConfig
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,
                                     adamw_update, clip_by_global_norm,
                                     float_leaves, global_norm, map_leaves,
                                     tree_flatten, tree_unflatten)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime import sharding as shd


# ---------------------------------------------------------------- training


class DataParallel:
    """A ``DeviceMesh``'s data-parallel ranks (axes ``("pod", "data")``,
    and ``model`` of size 1): this rank's shard of the batch, the
    gradient all-reduce and the ZeRO-1 ownership of the optimizer state.
    Every rank of the mesh constructs it at the same time (it creates a
    process group).

    Raises:
      NotImplementedError: a ``model`` axis larger than 1.
    """

    def __init__(self, mesh: Any):
        axes = shd.mesh_axes(mesh)
        if axes.get("model", 1) > 1:
            raise NotImplementedError(
                f"tensor parallelism over the 'model' axis ({axes}) is not "
                "ported yet (ROADMAP A10): use a mesh with model=1")
        self.mesh, self.axes = mesh, axes
        names = mesh.mesh_dim_names
        coord = {n: mesh.get_local_rank(n) for n in names}
        self.size = axes.get("pod", 1) * axes.get("data", 1)
        # the reference's batch spec ("pod", "data"): pod-major shards
        self.rank = coord.get("pod", 0) * axes.get("data", 1) \
            + coord.get("data", 0)
        self.data_rank = coord.get("data", 0)
        self.group = dist.new_group(sorted(mesh.mesh.flatten().tolist()))
        self.data_group = mesh.get_group("data") if "data" in names else None
        self._owners: Optional[list] = None

    def owners(self, params: Any) -> list:
        """The ZeRO-1 owner of each leaf of ``params`` (``tree_flatten``
        order; None: replicated), computed once."""
        if self._owners is None:
            self._owners = tree_flatten(shd.zero1_owners(params,
                                                         self.axes))[0]
        return self._owners

    def mine(self, owner: Optional[int]) -> bool:
        return owner is None or owner == self.data_rank

    def mean(self, tree: Any) -> Any:
        """The mean over the data-parallel ranks of every float leaf."""
        def one(t):
            t = t.clone()
            dist.all_reduce(t, group=self.group)
            return t / self.size
        return map_leaves(one, tree)

    def shard_opt(self, params: Any, opt: AdamWState) -> AdamWState:
        """``opt`` with an empty tensor in place of every leaf another
        rank owns (its own leaves as they are)."""
        own = self.owners(params)

        def cut(tree):
            if tree is None:
                return None
            flat, tdef = tree_flatten(tree)
            return tree_unflatten(tdef, [
                x if x is None or self.mine(o) else x.new_empty(0)
                for x, o in zip(flat, own)])

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
        """Every owned leaf of ``params`` from its owner (a new tensor on
        the other ranks, never written into the one given)."""
        flat, tdef = tree_flatten(params)
        if self.data_group is None:
            return params
        got = self._broadcast([x if isinstance(x, torch.Tensor) else None
                               for x in flat], self.owners(params), flat)
        return tree_unflatten(tdef, [g if g is not None else x
                                     for g, x in zip(got, flat)])

    def gather_opt(self, params: Any, opt: AdamWState) -> AdamWState:
        """The whole optimizer state on every rank (each leaf's m, v and
        master from its owner), as a checkpoint holds it."""
        if self.data_group is None:
            return opt
        own, shapes = self.owners(params), tree_flatten(params)[0]

        def full(tree):
            if tree is None:
                return None
            flat, tdef = tree_flatten(tree)
            return tree_unflatten(tdef, self._broadcast(flat, own, shapes))

        return opt._replace(m=full(opt.m), v=full(opt.v),
                            master=full(opt.master))


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


def make_train_step(model: Model, opt_cfg: AdamWConfig, rc: RunConfig, *,
                    total_steps: int = 100000, warmup: int = 1000,
                    accum_steps: int = 1, mesh: Any = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "gnorm", "lr_scale"})``: the mean loss of ``batch`` and its
    gradients (``accum_steps > 1``: the batch split into that many
    microbatches, their losses and gradients summed in order, then
    divided), the ``warmup_cosine`` multiplier at ``opt_state.step``,
    then ``adamw_update``. New tensors throughout: the step before stays
    as it was. With ``mesh`` (a ``DeviceMesh``) the step is data-parallel
    (module docstring); ``batch`` is then this rank's shard.

    Raises:
      NotImplementedError: a mesh whose ``model`` axis is larger than 1
        (ROADMAP A10).
    """
    dp = DataParallel(mesh) if mesh is not None else None

    def train_step(params, opt_state: AdamWState, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(model, params, batch, rc)
        else:
            split = lambda x: x.reshape(accum_steps, x.shape[0] // accum_steps,
                                        *x.shape[1:])
            micro = {k: split(v) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(batch.values())).device)
            grads = map_leaves(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(accum_steps):
                l, g = value_and_grad(model, params,
                                      {k: v[i] for k, v in micro.items()}, rc)
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
            if opt_cfg.grad_clip > 0:
                grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
            else:
                gnorm = global_norm(grads)
            flat, tdef = tree_flatten(grads)
            grads = tree_unflatten(tdef, [
                g if dp.mine(o) else None
                for g, o in zip(flat, dp.owners(params))])
            new_params, new_opt, _ = adamw_update(
                grads, opt_state, params,
                dataclasses.replace(opt_cfg, grad_clip=0.0), lr_scale)
            new_params = dp.broadcast_params(new_params)
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
