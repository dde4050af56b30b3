"""PyTorch/CUDA port of the EVA reproduction (``src/repro`` is the JAX
reference it is held against).

The layout mirrors ``repro`` module by module: ``core/`` (VQ weights,
matmul formulations, the planner, the quantization pass), ``kernels/``
(hand-written CUDA C++ kernels for Hopper, each with its plain PyTorch
version in ``ref.py``), ``models/`` (the dense transformer family),
``serve/`` (the continuous-batching engine) and ``configs/``.

Importing the package touches no GPU and needs neither ``nvcc`` nor
``triton``: kernels are compiled and loaded at their first launch
(``kernels/build.py``).

Every entry point takes an explicit ``device``. It defaults to
``"cuda"`` and raises when no GPU is present: nothing runs on the CPU
unless the caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another one.

    Raises:
      RuntimeError: a CUDA device was asked for (explicitly or by
        default) and PyTorch sees no GPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return dev


def tensor_device(tree) -> Optional[torch.device]:
    """Device of the first tensor found in a nested dict/list/VQWeight
    tree (None when it holds no tensor)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    elif hasattr(tree, "idx"):
        return tree.idx.device
    else:
        return None
    for sub in items:
        dev = tensor_device(sub)
        if dev is not None:
            return dev
    return None
