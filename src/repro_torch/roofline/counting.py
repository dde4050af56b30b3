"""Per-device costs of one step, counted while it runs (the job the
reference's ``roofline/hlo.py`` does by parsing XLA's HLO).

``StepCounter`` is a dispatch mode around one step on one rank, usually
over meta tensors on a fake process group (``launch/dryrun.py``). It
hands every op on DTensors back to DTensor (it returns
``NotImplemented``), so it sees the ops DTensor runs on this rank's
shards and the collectives it inserts, never the global, logical op.
DTensor infers a new op's output shape by running the global op on
fake tensors; those calls are not counted. A sequential scan over meta
tensors runs one step standing for all of them (``scan_steps``,
``repeated``). It counts:

  * FLOPs of the products (``torch.utils.flop_counter``'s formulas:
    matmuls, batched matmuls, convolutions, attention), on the local
    shapes; autograd's backward and remat's recomputation included, as
    the reference counts the dots of its program;
  * collective wire bytes a device sends, by op, under the reference's
    ring model (``hlo.py:149``) with group size g: all-reduce
    2(g-1)/g x bytes, all-gather and all-to-all (g-1)/g x the gathered
    bytes, reduce-scatter (g-1) x the scattered shard, a point-to-point
    send its bytes. A broadcast (ZeRO-1's owned leaves, which XLA
    lowers as an all-gather) counts as an all-gather of its bytes;
  * memory: the bytes of every storage the step allocates, live at its
    peak (``temp_bytes`` is that peak less the outputs) and at its end
    (``output_bytes``: the new tensors the step returns; a tensor
    updated in place, such as a decode cache, is an argument only).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import weakref
from typing import Any, Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# op name (its overload packet's) -> the reference's collective name
_COLLECTIVES = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}


# how many runs each op stands for (``repeated``)
_REPEAT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_repeat", default=1)


@contextlib.contextmanager
def repeated(n: int) -> Iterator[None]:
    """Inside it every op's FLOPs and collective bytes count ``n`` times:
    one step of a scan standing for all ``n`` of its steps."""
    token = _REPEAT.set(_REPEAT.get() * n)
    try:
        yield
    finally:
        _REPEAT.reset(token)


def scan_steps(n: int, x: torch.Tensor) -> Tuple[int, int]:
    """(steps to run, count of each) of an ``n``-step scan over ``x``:
    (n, 1), or over meta tensors (the dry run, shapes without values)
    (1, n), so one step is run and counted for all ``n``, as the
    reference's HLO counts a scan's body by its trip count. Its backward
    is then counted once a scan."""
    return (1, n) if x.device.type == "meta" else (n, 1)


def ring_bytes(op: str, nbytes: float, g: int) -> float:
    """Per-device wire bytes of one collective of ``nbytes`` (the
    gathered result of an all-gather, the shard of a reduce-scatter)
    over ``g`` ranks, the reference's ring model."""
    if g <= 1 and op != "collective-permute":
        return 0.0
    if op == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if op in ("all-gather", "all-to-all", "broadcast"):
        return nbytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(nbytes * (g - 1))
    if op == "collective-permute":
        return float(nbytes)
    return 0.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# the functional collectives (DTensor's), whose last argument names the
# group; the others (``torch.distributed``'s calls) take the group itself
_FUNCTIONAL = {"all_reduce", "all_gather_into_tensor",
               "all_gather_into_tensor_out", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast"}


def _group_size(args, name: str) -> int:
    """The number of ranks a collective's call spans."""
    import torch.distributed as dist

    if name in _FUNCTIONAL:
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(args[-1]).size()
    pg = next(a for a in args if isinstance(a, torch.ScriptObject)
              and a._type().name().endswith("ProcessGroup"))
    return dist.ProcessGroup.unbox(pg).size()


def _tensors(x) -> list:
    out: list = []
    torch.utils._pytree.tree_map(
        lambda t: out.append(t) if isinstance(t, torch.Tensor) else None, x)
    return out


@dataclasses.dataclass
class StepCosts:
    """What one step cost this rank."""
    flops: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    collective_bytes_by_op: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0


class StepCounter(TorchDispatchMode):
    """Counts a step's per-device FLOPs, collective bytes and memory (the
    module docstring). Use::

        counter = StepCounter()
        counter.arguments(inputs)
        with counter:
            out = step(*inputs)
        costs = counter.finish(out)
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.costs = StepCosts()
        self._live = 0
        self._seen: Dict[int, Any] = {}
        self._args: set = set()

    def arguments(self, tree: Any) -> None:
        """Record the step's inputs (this rank's shards) as its
        arguments."""
        from repro_torch.runtime import tensor_parallel as tp

        def one(t):
            if isinstance(t, torch.distributed.tensor.DTensor):
                t = t.to_local()
            key = t.untyped_storage()._cdata
            if key not in self._args:
                self._args.add(key)
                self.costs.argument_bytes += t.untyped_storage().nbytes()
            return t

        tp.map_tensors(one, tree)

    def _track(self, out) -> None:
        for t in _tensors(out):
            if isinstance(t, torch.distributed.tensor.DTensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen or key in self._args:
                continue
            n = st.nbytes()
            self._live += n
            self.costs.peak_bytes = max(self.costs.peak_bytes, self._live)

            def gone(key=key, n=n):
                self._live -= n
                self._seen.pop(key, None)

            try:
                self._seen[key] = weakref.finalize(st, gone)
            except TypeError:  # a storage without weak references
                self._seen[key] = None

    def _collective(self, name: str, args, kwargs, out) -> None:
        op = _COLLECTIVES[name]
        g = _group_size(args, name)
        ts = _tensors(args)
        if not ts:
            return
        if op == "all-gather":
            # the gathered result: the output buffer (the first tensor of
            # c10d's in-place form; g x the input of the functional one)
            n = (_nbytes(ts[0]) if name != "all_gather_into_tensor"
                 else _nbytes(ts[0]) * g)
            if name in ("allgather_", "allgather_into_tensor_coalesced_"):
                n = sum(_nbytes(t) for t in _tensors(args[0]))
        elif op == "reduce-scatter":
            n = (_nbytes(ts[0]) if name in ("reduce_scatter_",
                                            "_reduce_scatter_base_")
                 else _nbytes(ts[0]) // max(g, 1))
        else:
            n = _nbytes(ts[0])
        b = _REPEAT.get() * ring_bytes(op, n, g)
        c = self.costs
        c.collective_bytes += b
        c.collective_counts[op] = c.collective_counts.get(op, 0) \
            + _REPEAT.get()
        c.collective_bytes_by_op[op] = c.collective_bytes_by_op.get(op, 0.0) \
            + b

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it on the shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) \
                or any(isinstance(t, FakeTensor) for t in _tensors(out)) \
                or torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out     # DTensor's shape inference of a global op
        packet = func._overloadpacket
        if packet in self._flops:
            self.costs.flops += _REPEAT.get() * self._flops[packet](
                *args, **kwargs, out_val=out)
        name = packet.__name__
        if name in _COLLECTIVES:
            self._collective(name, args, kwargs, out)
        self._track(out)
        return out

    def finish(self, outputs: Any) -> StepCosts:
        """The costs, ``outputs`` (the step's result) giving the output
        bytes: its tensors allocated during the step."""
        seen: set = set()
        n = 0
        for t in _tensors(outputs):
            if isinstance(t, torch.distributed.tensor.DTensor):
                t = t.to_local()
            key = t.untyped_storage()._cdata
            if key in seen or key in self._args:
                continue
            seen.add(key)
            n += t.untyped_storage().nbytes()
        self.costs.output_bytes = n
        self.costs.temp_bytes = max(self.costs.peak_bytes - n, 0)
        return self.costs
