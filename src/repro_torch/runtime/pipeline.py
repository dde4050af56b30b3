"""Pipeline parallelism: a GPipe-style microbatch pipeline over a mesh
axis (``repro/runtime/pipeline.py``), typically ``pod``: links between
pods are the slowest, and point-to-point sends are the cheapest
collective pattern.

The layer stack is split into ``n_stages`` equal stages
(``split_stages``), one for each rank of the pipeline axis; a rank
holds only its own stage's layers. Every stage runs the same tick loop,
``n_micro + n_stages - 1`` ticks: stage 0 feeds the microbatches in,
each tick's activations go to the next stage by a send and a receive
(the reference's ``ppermute``), and the last stage collects the
outputs, which then reach every rank of the axis (the reference's
``psum`` of the last stage's outputs). The loop is differentiable, as
the reference's is through ``ppermute``'s transpose: the two
``torch.autograd.Function``s below carry the gradients back, the
backward of a send being a receive and the backward of a receive a
send. A pipelined training step is then autograd over the pipelined
forward.

Bubble fraction is the usual (P-1)/(T+P-1); choose n_micro >= 4*P.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_flatten, tree_unflatten


def split_stages(stacked_params: Any, n_stages: int) -> Any:
    """(L, ...) stacked layer params -> (n_stages, L/n_stages, ...)."""

    def one(x):
        L = x.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])

    flat, tdef = tree_flatten(stacked_params)
    return tree_unflatten(tdef, [one(x) for x in flat])


def stage_of(split_params: Any, stage: int) -> Any:
    """The layers of one stage (leaves (L/n_stages, ...)) of a
    ``split_stages`` tree: what a rank of the pipeline axis holds."""
    flat, tdef = tree_flatten(split_params)
    return tree_unflatten(tdef, [x[stage] for x in flat])


def _exchange(send: Optional[torch.Tensor], to: Optional[int],
              recv: Optional[torch.Tensor], frm: Optional[int], group):
    ops = []
    if send is not None and to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, group))
    if recv is not None and frm is not None:
        ops.append(dist.P2POp(dist.irecv, recv, frm, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Shift(torch.autograd.Function):
    """One tick's hop: this stage's output to the next stage, the
    previous stage's output received (zeros on stage 0). Backward: the
    gradient of what was received goes back to the previous stage, and
    the gradient of what was sent comes from the next (zeros on the last
    stage)."""

    @staticmethod
    def forward(ctx, y, prev, nxt, group):
        ctx.prev, ctx.nxt, ctx.group = prev, nxt, group
        buf = torch.zeros_like(y)
        _exchange(y, nxt, buf, prev, group)
        return buf

    @staticmethod
    def backward(ctx, g_buf):
        g_y = torch.zeros_like(g_buf)
        _exchange(g_buf, ctx.prev, g_y, ctx.nxt, ctx.group)
        return g_y, None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every rank of the axis (a sum over the
    axis of outputs that are zero but on the last stage). Its output is
    replicated, so each rank's gradient is its own input's, as the
    transpose of the reference's ``psum`` into a replicated result."""

    @staticmethod
    def forward(ctx, outs, group):
        outs = outs.clone()
        dist.all_reduce(outs, group=group)
        return outs

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor, *, group,
                   n_stages: int, stage: int) -> torch.Tensor:
    """Run the tick loop on this rank (stage ``stage`` of ``n_stages``,
    the ranks of ``group`` in stage order). Returns (n_micro, mb, ...)
    outputs, valid on the LAST stage (zeros elsewhere)."""
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    ranks = dist.get_process_group_ranks(group)
    prev = ranks[stage - 1] if stage > 0 else None
    nxt = ranks[stage + 1] if stage < n_stages - 1 else None
    buf = torch.zeros_like(x_micro[0])
    outs = [torch.zeros_like(x_micro[0]) for _ in range(n_micro)]
    first = torch.tensor(stage == 0, device=x_micro.device)
    last = torch.tensor(stage == n_stages - 1, device=x_micro.device)
    for t in range(ticks):
        feed = x_micro[min(t, n_micro - 1)]
        # as in the reference's where: buf and y enter every stage's graph
        # (with zero gradients where unused), so every stage runs the same
        # backward, each tick's hop included
        x_in = torch.where(first, feed, buf)
        y = stage_fn(stage_params, x_in)
        out_t = t - (n_stages - 1)
        if out_t >= 0:
            outs[out_t] = torch.where(last, y, outs[out_t])
        buf = _Shift.apply(y, prev, nxt, group)
    return torch.stack(outs)


def make_pipelined_forward(layer_fn: Callable[[Any, torch.Tensor],
                                              torch.Tensor],
                           mesh: Any, *, axis: str = "pod",
                           n_micro: int = 8):
    """Builds ``f(stage_params, x) -> y`` on a ``DeviceMesh``: this rank's
    stage is its coordinate on ``axis``, ``stage_params`` its layers
    (leaves with a leading L/n_stages axis: ``stage_of`` of a
    ``split_stages`` tree), x (batch, ...) with batch % n_micro == 0, the
    same on every rank. Returns y (batch, ...) on every rank."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)

    def stage_fn(params_slice, x):
        flat, tdef = tree_flatten(params_slice)
        for i in range(flat[0].shape[0]):
            x = layer_fn(tree_unflatten(tdef, [a[i] for a in flat]), x)
        return x

    def fwd(stage_params, x):
        B = x.shape[0]
        assert B % n_micro == 0
        x_micro = x.reshape(n_micro, B // n_micro, *x.shape[1:])
        outs = pipeline_apply(stage_fn, stage_params, x_micro, group=group,
                              n_stages=n_stages, stage=stage)
        # the last stage's outputs to every stage
        last = torch.tensor(stage == n_stages - 1, device=x.device)
        outs = _FromLast.apply(torch.where(last, outs,
                                           torch.zeros_like(outs)), group)
        return outs.reshape(B, *outs.shape[2:])

    return fwd
