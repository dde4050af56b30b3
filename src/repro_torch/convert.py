"""Convert the reference's parameter trees into the port's.

``from_jax_params(tree)`` takes a JAX param pytree whose array leaves
were turned into numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``; a ``VQWeight`` stays a node with numpy ``idx``/``codebooks``/
``scale`` and its static ``K, N, d, n, splits``) and returns the port's
params on ``device``:

  * dicts map key by key; numpy arrays become tensors of the same dtype
    (bf16 included);
  * a VQWeight-like node (anything with ``idx``, ``codebooks``,
    ``scale``, ``K``, ``N``, ``d``, ``n``, ``splits``) becomes the port's
    ``VQWeight``, and a VQLogitsHead-like node (``codebook``, ``assign``,
    ``scale``) the port's ``VQLogitsHead``;
  * the stacked layer axes the reference scans over (``"layers"``,
    deepseek's dense prefix ``"pre_layers"``, the xLSTM, RecurrentGemma and
    Vision ``"groups"``, RecurrentGemma's ``"trail"`` and Whisper's
    ``"encoder"`` and ``"decoder"``, leading dim L on every leaf) become
    lists of L per-layer dicts (an (L,) leaf, Vision's gates, L scalars),
    attached KV-VQ codebooks included: an attention node's ``kv_cb``
    {"k", "v"} of shape (L, Hk, R, 256, vd) becomes one (Hk, R, 256, vd)
    pair per layer (an MLA node's {"lat"} (L, 1, R, 256, vd) likewise).

The leaves may also be tensors (on any device; they are moved to
``device``), tuples (a named tuple, the optimizer's ``AdamWState``, keeps
its type) and None, as ``checkpoint.manager`` restores them.

``to_reference_layout(tree)`` is the inverse of the unstacking: every
list of per-layer dicts under one of those keys becomes one node
whose leaves (and
VQWeight tensors) are stacked on a leading L axis, numpy arrays with
``np.stack`` and tensors with ``torch.stack``. A tensor several layers
share (the KV-VQ codebooks ``attach_kv_codebooks`` attaches) is stacked
like any other, as the reference holds it. A VQLogitsHead (the LM head,
outside the layers) stays as it is.

The port imports nothing of the reference: the VQWeight and the
VQLogitsHead are recognized by their attributes.
"""
from __future__ import annotations

import types
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.logits_vq import VQLogitsHead
from repro_torch.core.vq import VQWeight

_VQ_FIELDS = ("idx", "codebooks", "scale", "K", "N", "d", "n", "splits")
_VQL_FIELDS = ("codebook", "assign", "scale")
_STACKED = ("layers", "pre_layers", "groups", "trail", "encoder", "decoder")


def is_vq(node: Any) -> bool:
    """Whether ``node`` is a VQWeight of either package (by attributes)."""
    return all(hasattr(node, f) for f in _VQ_FIELDS)


def is_vql(node: Any) -> bool:
    """Whether ``node`` is a VQLogitsHead of either package."""
    return all(hasattr(node, f) for f in _VQL_FIELDS)


def to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    """numpy (or array-like) -> tensor of the same dtype on ``device``
    (a copy: arrays handed out by JAX are read-only); a tensor moves."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(node: Any, device: torch.device,
             stacked: Tuple[str, ...] = _STACKED) -> Any:
    if is_vq(node):
        return VQWeight(idx=to_tensor(node.idx, device),
                        codebooks=to_tensor(node.codebooks, device),
                        scale=to_tensor(node.scale, device), K=int(node.K),
                        N=int(node.N), d=int(node.d), n=int(node.n),
                        splits=tuple(int(s) for s in node.splits))
    if is_vql(node):
        return VQLogitsHead(*(to_tensor(getattr(node, f), device)
                              for f in _VQL_FIELDS))
    if isinstance(node, dict):
        return {k: (_unstack(v, device) if k in stacked
                    else _convert(v, device, stacked))
                for k, v in node.items()}
    if isinstance(node, tuple):
        items = (_convert(v, device, stacked) for v in node)
        return type(node)(*items) if hasattr(node, "_fields") else tuple(items)
    if node is None:
        return None
    return to_tensor(node, device)


def _index(node: Any, i: int) -> Any:
    """Layer ``i`` of a stacked subtree."""
    if is_vq(node):
        return types.SimpleNamespace(
            idx=node.idx[i], codebooks=node.codebooks[i],
            scale=node.scale[i], K=node.K, N=node.N, d=node.d, n=node.n,
            splits=node.splits)
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node[i]
    return np.asarray(node)[i]


def _leading(node: Any) -> int:
    if is_vq(node):
        return int(np.shape(node.idx)[0])
    if isinstance(node, dict):
        return _leading(next(iter(node.values())))
    return int(np.shape(node)[0])


def _unstack(node: Any, device: torch.device) -> list:
    return [_convert(_index(node, i), device) for i in range(_leading(node))]


def from_jax_params(tree: Any, *, device: DeviceLike = None,
                    unstack: bool = True) -> Any:
    """The port's params for a numpy-leaved JAX param tree (see module
    docstring). ``device`` defaults to "cuda". ``unstack=False`` keeps
    every node as it is (a tree that is no param tree, such as an engine
    snapshot's cache, whose ``"groups"`` are cache leaves)."""
    return _convert(tree, resolve_device(device),
                    _STACKED if unstack else ())


def _stack(layers: list) -> Any:
    first = layers[0]
    if is_vq(first):
        return VQWeight(idx=_stack([v.idx for v in layers]),
                        codebooks=_stack([v.codebooks for v in layers]),
                        scale=_stack([v.scale for v in layers]), K=first.K,
                        N=first.N, d=first.d, n=first.n,
                        splits=tuple(first.splits))
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(layers)
    return np.stack(layers)


def to_reference_layout(tree: Any) -> Any:
    """The reference's layout of a port tree (see module docstring): the
    per-layer lists of the stacked segments (``_STACKED``) stacked on L;
    everything else as it is."""
    if is_vq(tree) or is_vql(tree):
        return tree
    if isinstance(tree, dict):
        return {k: (_stack(v) if k in _STACKED and isinstance(v, list)
                    else to_reference_layout(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = (to_reference_layout(v) for v in tree)
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return tree
