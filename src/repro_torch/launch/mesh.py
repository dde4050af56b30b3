"""Device meshes (``repro/launch/mesh.py``).

The production meshes are returned as axis sizes only (the sharding
rules, ``runtime/sharding.py``, take them as they are):

  single pod:  {"data": 16, "model": 16}              = 256 devices
  multi pod:   {"pod": 2, "data": 16, "model": 16}    = 512 devices

``make_mesh`` and ``make_local_mesh`` build a ``DeviceMesh`` over the
running ``torch.distributed`` process group (one process a device).
Importing this module touches no device and no process group.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple


import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process
    group (``torch.distributed`` initialized, world size = the product of
    ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_local_mesh(model: int = 1, data: Optional[int] = None):
    """A ``("data", "model")`` mesh over every rank of the process group
    (``data`` defaults to world size // ``model``)."""
    n = dist.get_world_size()
    data = data if data is not None else n // model
    return make_mesh((data, model), ("data", "model"))
