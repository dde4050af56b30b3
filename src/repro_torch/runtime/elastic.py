"""Elastic scaling: restart training on another number of ranks
(``repro/runtime/elastic.py``).

Checkpoints store whole, unsharded host arrays (``checkpoint/
manager.py``) and the data pipeline is stateless and counter-based
(``data/pipeline.py``), so an elastic restart rebuilds the mesh at the
new size, recomputes the ZeRO-1 owners, places the restored state and
resumes at the saved step: the global batch and the optimizer's
arithmetic do not depend on the number of data-parallel ranks, nor on
the ``model`` ranks the params are split over.
"""
from __future__ import annotations

from typing import Any, List

from repro_torch import DeviceLike, resolve_device
from repro_torch.convert import from_jax_params
from repro_torch.optim.adamw import AdamWState, tree_flatten, tree_unflatten
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import tensor_parallel as tp


def reshard_state(params: Any, opt_state: AdamWState, model, mesh: Any, *,
                  device: DeviceLike = None):
    """Restored (host) ``params`` and ``opt_state`` placed for this rank
    of ``mesh`` (a ``DeviceMesh``) on ``device`` (default "cuda"): the
    params whole, or with a ``model`` axis larger than 1 as DTensors on
    its sub-mesh, each placed by its spec (``tensor_parallel.
    distribute``); the optimizer state of the leaves this rank's data
    coordinate owns under ZeRO-1 (``sharding.zero1_owners`` on the new
    mesh) and of the replicated ones, cut to this rank's ``model``
    shard, an empty tensor for the rest."""
    dev = resolve_device(device)
    params = from_jax_params(params, device=dev)
    owners = tree_flatten(shd.zero1_owners(params, shd.mesh_axes(mesh)))[0]
    me = (mesh.get_local_rank("data") if "data" in mesh.mesh_dim_names
          else 0)
    mm = tp.model_mesh(mesh)
    specs = tp.flat_specs(tp.port_specs(params, mesh), params)
    cut = ((lambda x, i: x) if mm is None else
           (lambda x, i: tp.local_shard(x, specs[i], mesh)))

    def place(tree):
        if tree is None:
            return None
        flat, tdef = tree_flatten(from_jax_params(tree, device=dev))
        return tree_unflatten(tdef, [
            x if x is None else cut(x, i)
            if o is None or o == me else x.new_empty(0)
            for i, (x, o) in enumerate(zip(flat, owners))])

    opt = AdamWState(step=opt_state.step.to(dev), m=place(opt_state.m),
                     v=place(opt_state.v), master=place(opt_state.master))
    if mm is not None:
        params = tp.distribute(params, mesh, tp.port_specs(params, mesh))
    return params, opt


def valid_dp_sizes(global_batch: int, num_devices: int,
                   model_parallel: int) -> List[int]:
    """Data-parallel sizes an elastic restart may choose from."""
    out = []
    for dp in range(1, num_devices // model_parallel + 1):
        if dp * model_parallel <= num_devices and global_batch % dp == 0:
            out.append(dp)
    return out
