"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
number of engine ticks, each inside a host span of the benchmark's own
(``evabench.tick``), read back into device operations by tick.

Every operation on the device (kernels, copies, sets) counts toward the
busy time; the profiler's mirror of the host spans on the device
timeline does not. Each device operation is given to the tick whose host
span holds its start: a tick's work has ended on the device when
``step()`` returns, since the engine reads its tokens back. The port's
kernels are named by the CUDA functions they launch (``KERNEL_FUNCTIONS``,
a frozen copy of ``chip_smoke.py``'s map); everything else is "other".

Idle gaps are the stretches of the traced window with no device
operation. A gap of ``GAP_US`` or more is put down to the innermost host
operation running at its middle (the engine's own Python, where no
operation runs inside a tick; the harness's, between ticks).
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

SPAN = "evabench.tick"
# profiles taken while one records no device event (the tracer has once
# dropped every event of a replay that ran)
ATTEMPTS = 3
GAP_US = 5.0

# the CUDA functions of each of the port's kernels, as the profiler names
# them (chip_smoke.py KERNEL_FUNCTIONS)
KERNEL_FUNCTIONS = {
    "fused_vq_kernel": "fused_vq_matmul", "split_reduce_kernel":
    "fused_vq_matmul (split reduce)", "flash_decode_kernel": "flash_decode",
    "flash_decode_merge_kernel": "flash_decode (merge)",
    "flash_decode_kvq_kernel": "flash_decode_kvq",
    "flash_decode_paged_kernel": "flash_decode_paged",
    "flash_decode_kvq_paged_kernel": "flash_decode_kvq_paged",
    "kvq_merge_kernel": "flash_decode_kvq (merge)",
    "dequant_gemv_kernel": "dequant_gemv",
    "dequant_reduce_kernel": "dequant_gemv (split reduce)",
    "dequant_split_x_kernel": "dequant_gemv (x split)",
    "int8_gemm_kernel": "int8_gemm",
    "vq_gemm_kernel": "vq_gemm", "oc_lookup_kernel": "oc_lookup",
    "oc_split_reduce_kernel": "oc_lookup (split reduce)",
}


def label(name: str, _memo: Dict[str, str] = {}) -> str:
    """The port's kernel a CUDA function belongs to, or "other"."""
    if name not in _memo:
        _memo[name] = next((lab for fn, lab in KERNEL_FUNCTIONS.items()
                            if re.search(rf"\b{fn}\b", name)), "other")
    return _memo[name]


def kernel_of(lab: str) -> str:
    """The kernel a label counts toward ("fused_vq_matmul (split
    reduce)" toward "fused_vq_matmul")."""
    return lab.split(" (")[0]


@dataclasses.dataclass
class DeviceOp:
    name: str
    label: str
    start: int          # ns, the profiler's clock
    end: int


@dataclasses.dataclass
class TracedTick:
    start: int
    end: int
    info: object        # what the tick function returned (a loop.Tick)
    ops: List[DeviceOp] = dataclasses.field(default_factory=list)

    def seconds(self, pred: Callable[[DeviceOp], bool]) -> float:
        return sum(o.end - o.start for o in self.ops if pred(o)) * 1e-9

    def count(self, lab: str) -> int:
        return sum(1 for o in self.ops if o.label == lab)

    def busy(self) -> float:
        """Seconds of the tick in which an operation ran on the device."""
        total, end = 0, self.start
        for o in sorted(self.ops, key=lambda o: o.start):
            a, b = max(o.start, end), min(o.end, self.end)
            if b > a:
                total += b - a
                end = b
        return total * 1e-9


def complete(ticks: List[TracedTick], lab: str, want) -> List[TracedTick]:
    """The ticks whose trace holds every launch of ``lab`` they made
    (``want(tick)`` of them), or none when fewer than half of them do:
    the tracer can lose events at the edges of a stretch, and a tick that
    lost some cannot be given the shapes of its calls."""
    whole = [t for t in ticks if t.count(lab) == want(t)]
    return whole if ticks and 2 * len(whole) >= len(ticks) else []


@dataclasses.dataclass
class Trace:
    ticks: List[TracedTick]
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _events(prof):
    return prof.profiler.kineto_results.events()


def _is_device(e, cuda) -> bool:
    if e.device_type() != cuda:
        return False
    annotation = getattr(e, "is_user_annotation", None)
    return not (annotation() if annotation else False) and e.name() != SPAN


def profile_ticks(tick: Callable[[], object], n: int) -> Optional[Trace]:
    """Run ``tick`` ``n`` times under the profiler and read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(ATTEMPTS):
        infos = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                with record_function(SPAN):
                    infos.append(tick())
        events = _events(prof)
        device = [e for e in events if _is_device(e, cuda)]
        if device:
            return read(events, device, infos, cuda)
    return None


def read(events, device, infos, cuda) -> Trace:
    spans = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.name() == SPAN and e.device_type() != cuda)
    ticks = [TracedTick(a, b, info) for (a, b), info in zip(spans, infos)]
    starts = [t.start for t in ticks]
    ops = sorted((DeviceOp(e.name(), label(e.name()), e.start_ns(),
                           e.end_ns()) for e in device),
                 key=lambda o: o.start)
    for o in ops:
        i = bisect.bisect_right(starts, o.start) - 1
        if i >= 0 and o.start <= ticks[i].end:
            ticks[i].ops.append(o)
    lo, hi = ticks[0].start, ticks[-1].end
    # the union of the device operations inside the window, and its gaps
    busy, gaps, cur_a, cur_b = 0, [], None, lo
    for o in ops:
        a, b = max(o.start, lo), min(o.end, hi)
        if b <= a:
            continue
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    gaps.append((cur_b, hi))
    by_name: Dict[str, float] = {}
    for o in ops:
        key = o.label if o.label != "other" else o.name[:96]
        by_name[key] = by_name.get(key, 0.0) + (o.end - o.start) * 1e-9
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Trace(ticks, (hi - lo) * 1e-9, busy * 1e-9, top_ops,
                 _gaps_by_host(events, cuda, gaps, spans))


def _gaps_by_host(events, cuda, gaps, spans) -> List[Tuple[str, float]]:
    host = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in events
                   if e.device_type() != cuda and e.name() != SPAN),
                  key=lambda h: h[0])
    starts = [h[0] for h in host]
    span_starts = [a for a, _ in spans]
    out: Dict[str, float] = {}
    for a, b in gaps:
        if b <= a:
            continue
        dur = (b - a) * 1e-9
        if (b - a) < GAP_US * 1e3:
            key = f"gaps under {GAP_US:g} us"
        else:
            mid = (a + b) // 2
            key = None
            i = bisect.bisect_right(starts, mid) - 1
            # the latest-started host op running at ``mid`` is the
            # innermost one (host ops nest)
            for j in range(i, max(-1, i - 512), -1):
                if host[j][1] >= mid:
                    key = host[j][2][:96]
                    break
            if key is None:
                k = bisect.bisect_right(span_starts, mid) - 1
                inside = k >= 0 and mid <= spans[k][1]
                key = ("engine.step (host code)" if inside
                       else "harness, between steps")
        out[key] = out.get(key, 0.0) + dur
    return sorted(out.items(), key=lambda kv: -kv[1])[:10]
