"""AdamW (fp32 m and v, bias correction, decoupled weight decay on the
fp32 base, optional fp32 master copies) and SGD with momentum over the
port's param trees (``repro/optim/adamw.py``).

A param tree is nested dicts, lists (the per-layer dicts) and tuples
whose leaves are tensors. A ``VQWeight`` node, an integer tensor and a
leaf whose gradient is None are left as they are: they carry no
optimizer state (None in ``m``, ``v`` and ``master``), and the update
returns the param itself. Every update returns new tensors and never
writes into the ones it is given, so a caller may keep the step before
and after.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.core.vq import VQWeight


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    use_master: bool = False   # keep fp32 master copies (bf16 training)


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any
    v: Any
    master: Any          # fp32 master params, or None


def _trainable(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *others)`` at every floating-point tensor of ``tree``,
    the leaves at the same place in ``rest`` beside it (None where a tree
    of ``rest`` is None). A VQWeight node, an integer tensor or None of
    ``tree`` maps to None. Dicts are walked in sorted key order, as
    ``jax.tree_util`` walks them, so every sum over leaves (the global
    norm) adds them in the reference's order whatever order a tree's
    dicts were built in."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *[None if r is None else r[k]
                                             for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, *[None if r is None else r[i]
                                              for r in rest])
                          for i, v in enumerate(tree))
    if _trainable(tree):
        return fn(tree, *rest)
    return None


def float_leaves(tree: Any) -> list:
    """The floating-point tensors of ``tree`` in ``map_leaves`` order."""
    out: list = []
    map_leaves(out.append, tree)
    return out


def _zeros_like(tree: Any) -> Any:
    return map_leaves(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device), tree)


def adamw_init(params: Any, cfg: AdamWConfig) -> AdamWState:
    dev = next(iter(float_leaves(params)), torch.empty(0)).device
    master = (map_leaves(lambda x: x.detach().float().clone(), params)
              if cfg.use_master else None)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=_zeros_like(params), v=_zeros_like(params),
                      master=master)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares (None leaves
    skipped)."""
    sums = [torch.sum(torch.square(x.float())) for x in float_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return map_leaves(lambda g: g * scale.to(g.dtype), grads), gnorm


def tree_flatten(tree: Any) -> Tuple[list, Any]:
    """(leaves, structure): every node of ``tree`` that is no dict, list
    or tuple (a tensor, a VQWeight, None ...), in ``map_leaves`` order."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


_LEAF = object()


def tree_unflatten(structure: Any, leaves: list) -> Any:
    """``tree_flatten``'s inverse."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    return walk(structure)


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 cfg: AdamWConfig,
                 lr_scale: Union[torch.Tensor, float] = 1.0
                 ) -> Tuple[Any, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm): the global norm of
    ``grads`` before clipping. A leaf whose gradient is None keeps its
    param and its state as they are."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * lr_scale

    flat_p, tdef = tree_flatten(params)
    flat_g, flat_m, flat_v = (tree_flatten(t)[0]
                              for t in (grads, state.m, state.v))
    flat_mast = (tree_flatten(state.master)[0] if state.master is not None
                 else [None] * len(flat_p))
    new_p, new_m, new_v, new_mast = [], [], [], []
    for p, g, m, v, mast in zip(flat_p, flat_g, flat_m, flat_v, flat_mast):
        if g is None:  # no gradient: the param and its state as they are
            new_p.append(p), new_m.append(m), new_v.append(v)
            new_mast.append(mast)
            continue
        g32 = g.float()
        m_ = cfg.b1 * m + (1 - cfg.b1) * g32
        v_ = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mhat = m_ / b1c
        vhat = v_ / b2c
        base = mast if mast is not None else p.float()
        new32 = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                             + cfg.weight_decay * base)
        new_p.append(new32.to(p.dtype)), new_m.append(m_), new_v.append(v_)
        new_mast.append(new32)
    new_state = AdamWState(
        step=step, m=tree_unflatten(tdef, new_m),
        v=tree_unflatten(tdef, new_v),
        master=(None if state.master is None
                else tree_unflatten(tdef, new_mast)))
    new_params = tree_unflatten(tdef, new_p)
    return new_params, new_state, gnorm


# ----------------------------------------------------------------- SGD-M ---


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 1e-2
    momentum: float = 0.9
    grad_clip: float = 0.0


class SGDState(NamedTuple):
    step: torch.Tensor
    mom: Any


def sgd_init(params: Any, cfg: SGDConfig) -> SGDState:
    dev = next(iter(float_leaves(params)), torch.empty(0)).device
    return SGDState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mom=_zeros_like(params))


@torch.no_grad()
def sgd_update(grads: Any, state: SGDState, params: Any, cfg: SGDConfig,
               lr_scale: Union[torch.Tensor, float] = 1.0
               ) -> Tuple[Any, SGDState, torch.Tensor]:
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)

    flat_p, tdef = tree_flatten(params)
    flat_g, flat_mom = tree_flatten(grads)[0], tree_flatten(state.mom)[0]
    new_p, new_mom = [], []
    for p, g, mom in zip(flat_p, flat_g, flat_mom):
        if g is None:
            new_p.append(p), new_mom.append(mom)
            continue
        mom_ = cfg.momentum * mom + g.float()
        new_p.append((p.float() - cfg.lr * lr_scale * mom_).to(p.dtype))
        new_mom.append(mom_)
    return (tree_unflatten(tdef, new_p),
            SGDState(step=state.step + 1, mom=tree_unflatten(tdef, new_mom)),
            gnorm)
