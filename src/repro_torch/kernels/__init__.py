"""Hand-written CUDA kernels of the port, one package each, mirroring
``repro/kernels``: ``ops.py`` (the wrapper, its ``launches`` counter and
plan backend), ``ref.py`` (the plain PyTorch version) and
``csrc/<name>.cu`` (the kernel, built by ``build.py`` at first use). A
kernel may share its package with another (``build.kernel_dir``):
``flash_decode_kvq`` lives in ``flash_decode``, as in the reference.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Only a launch on the card adds to its
``launches`` count. Under a CUDA graph the wrapper runs once, at
capture; the serving step's graph (``serve/graphs.StepGraph``) takes
that count back (``set_launch_counts``) and adds it again at every
replay (``add_launch_counts``), so the counts are launches that ran on
the card, replays included.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.kernels.build import KERNEL_NAMES, kernel_dir


def wrappers() -> Dict[str, object]:
    """name -> wrapper function of every ported kernel (the function of
    that name in its package's ``ops.py``)."""
    return {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{kernel_dir(name)}.ops"), name)
        for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def set_launch_counts(counts: Dict[str, int]) -> None:
    for name, fn in wrappers().items():
        fn.launches = counts[name]


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (name -> launches) to the wrappers' counts."""
    fns = wrappers()
    for name, k in counts.items():
        fns[name].launches += k
