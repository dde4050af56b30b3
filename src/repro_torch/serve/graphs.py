"""Serving steps as CUDA graphs: the port's counterpart of the reference
engine's ``jax.jit`` of its batched decode step and of its prefill, one
trace per length bucket (``repro/serve/engine.py``). The reference has
no module of its own for this.

    step = StepGraph(fn, {"tokens": ((B, 1), torch.int32)}, device)
    out = step(tokens=host_array)    # copy the inputs in, replay

Building a step runs ``fn`` once over its static input buffers, the
warm-up: kernel libraries load, the lookup kernels' occupancy queries
and cuBLAS's handles are made, the planner's cache fills. What the
warm-up writes in place stays written; the caller undoes it. On a CUDA
device the warm-up runs on a side stream, and ``fn`` is then captured
into a ``torch.cuda.CUDAGraph``. A call copies the host inputs into the
static buffers (from pinned host buffers, without blocking the host)
and replays the graph; its outputs are the tensors the capture
returned, overwritten by every replay. A capture or a launch that fails
raises; nothing runs the step eagerly on the card.

Each graph's memory pool is its own unless the caller hands it a
``pool`` (``torch.cuda.graph_pool_handle()``) to share. Graphs that
share a pool may be replayed in any order as long as each graph's
outputs are consumed before another graph of that pool replays: a
graph's outputs stay allocated as long as its step lives, so no later
capture places anything over them, but a later capture may place its
outputs over an earlier graph's freed intermediates, which that graph's
next replay writes again.

On the CPU a call runs ``fn`` directly over the same static buffers.
``EagerStep`` has the same interface and runs ``fn`` directly on every
device: the engine's exact-length prefill of the families whose prefill
cannot be bucketed (MoE), where a graph would be captured for each
prompt length and replayed about once.

Kernel wrappers count their launches on the host (``kernels``), so under
a graph they would tick only at capture. The step records each
wrapper's count over the capture (``launches``), takes back what the
warm-up and the capture added, and adds ``launches`` at every replay:
``kernels.launch_counts()`` then counts the launches that ran on the
card.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels

Spec = Tuple[Tuple[int, ...], torch.dtype]


def tensor_leaves(tree: Any) -> Iterable[torch.Tensor]:
    """The tensors of a nested dict/list/tuple tree, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)


class HostInputs:
    """Fixed device buffers fed from host arrays. ``load`` writes each
    array into a host buffer (pinned on CUDA) and copies it to its
    device buffer without blocking the host; the next ``load`` first
    waits until those copies have read their host buffers."""

    def __init__(self, specs: Dict[str, Spec], device: torch.device):
        self.device = device
        pin = device.type == "cuda"
        self.host = {n: torch.zeros(s, dtype=dt, pin_memory=pin)
                     for n, (s, dt) in specs.items()}
        self.dev = {n: torch.zeros(s, dtype=dt, device=device)
                    for n, (s, dt) in specs.items()}
        self._copied: Optional[torch.cuda.Event] = None

    def load(self, arrays: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        if self._copied is not None:
            self._copied.synchronize()
        for n, a in arrays.items():
            host = self.host[n]
            host.numpy()[...] = np.asarray(a).reshape(host.shape)
            self.dev[n].copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        return self.dev


class StepGraph:
    """One serving step over static inputs: a CUDA graph replay on the
    card, a direct call on the CPU (module docstring).

    Args:
      fn: the step; called as ``fn(**inputs)`` with the static device
        buffers, it returns a tensor or a tree of tensors.
      inputs: name -> (shape, dtype) of each input.
      device: where the step runs.
      pool: a graph memory pool to capture into, shared with other
        steps (module docstring); None gives the graph its own.

    Attributes:
      launches: kernel name -> launches of one replay (empty on the CPU).
      build_s: host seconds the build took: warm-up and, on CUDA, the
        capture, instantiation included.
    """

    def __init__(self, fn: Callable[..., Any], inputs: Dict[str, Spec],
                 device: torch.device, *, pool: Any = None):
        self.fn = fn
        self.inputs = HostInputs(inputs, device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.launches: Dict[str, int] = {}
        t0 = time.perf_counter()
        counts = kernels.launch_counts()
        with torch.no_grad():
            if device.type == "cuda":
                self._capture(pool)
            else:
                fn(**self.inputs.dev)
        self.build_s = time.perf_counter() - t0
        kernels.set_launch_counts(counts)

    def _capture(self, pool: Any) -> None:
        static = self.inputs.dev
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(**static)
        torch.cuda.current_stream().wait_stream(side)
        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        # a garbage collection during the capture could free another
        # graph, which the capture forbids and which invalidates it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = self.fn(**static)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        self.launches = {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}

    def release(self) -> None:
        """Free the graph and its outputs (its memory pool, once no other
        graph shares it); the step cannot be called after."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = self.fn = None

    def __call__(self, **arrays: Any) -> Any:
        if self.fn is None:
            raise RuntimeError("this step was released")
        static = self.inputs.load(arrays)
        if self.graph is None:
            with torch.no_grad():
                return self.fn(**static)
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        return self.outputs


class EagerStep:
    """A serving step with ``StepGraph``'s interface that runs ``fn``
    eagerly over its static input buffers on every device: nothing is
    captured, so each call launches its kernels (and counts them) as it
    goes. ``launches`` is empty and ``build_s`` 0."""

    graph = None
    outputs = None

    def __init__(self, fn: Callable[..., Any], inputs: Dict[str, Spec],
                 device: torch.device):
        self.fn = fn
        self.inputs = HostInputs(inputs, device)
        self.launches: Dict[str, int] = {}
        self.build_s = 0.0

    def release(self) -> None:
        self.fn = None

    def __call__(self, **arrays: Any) -> Any:
        if self.fn is None:
            raise RuntimeError("this step was released")
        static = self.inputs.load(arrays)
        with torch.no_grad():
            return self.fn(**static)
