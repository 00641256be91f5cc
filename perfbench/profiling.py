"""From a ``torch.profiler`` trace to the numbers the per-layer metrics read.

The device's busy time is the union of its operation spans, not their sum:
under programmatic dependent launch K1's fixup kernel starts while its
segment kernel runs, and a sum counts that overlap twice. This module is
the repository's one copy of the kernel groups and the union;
``scripts/torch_spmm2_tune.py`` reads it too. Idle gaps are named by the
host operation that was running in their middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

TOP = 10  # entries of each breakdown list


def kernel_group(name: str) -> str:
    """The group of a device operation, by its name."""
    low = name.lower()
    if "spmm2" in low:
        return "K1 spmm2"
    if "sir_step" in low:
        return "K2 sir_step"
    if "gemm" in low or "xmma" in low or "cutlass" in low or "matmul" in low:
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "reduce" in low or "softmax" in low:
        return "reduction/softmax"
    if "cat" in low or "index" in low or "gather" in low:
        return "copy/index"
    return "elementwise/other"


def is_kernel(name: str) -> bool:
    """A launched kernel, as against a copy or fill the runtime does."""
    return not name.startswith(("Memcpy", "Memset"))


def merge(spans) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` spans as sorted disjoint intervals."""
    out: list[list[float]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def union(spans) -> float:
    return sum(b - a for a, b in merge(spans))


@dataclasses.dataclass
class Trace:
    """Device operations and top-level host operations of a traced
    stretch, times in microseconds on the profiler's clock; ``wall_s`` is
    the stretch's length on the host clock."""

    device_ops: list  # (name, start_us, end_us)
    host_ops: list  # (name, start_us, end_us), top-level only
    wall_s: float

    def spans(self, pred=lambda name: True) -> list:
        return [(a, b) for n, a, b in self.device_ops if pred(n)]

    def busy_s(self, pred=lambda name: True) -> float:
        return union(self.spans(pred)) / 1e6

    def count(self, pred) -> int:
        return sum(1 for n, _, _ in self.device_ops if pred(n))


def reduce_events(events, wall_s: float) -> Trace:
    """A :class:`Trace` from ``prof.events()``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for evt in events:
        span = (evt.name, float(evt.time_range.start), float(evt.time_range.end))
        if evt.device_type == DeviceType.CUDA:
            # a user annotation (``Optimizer.step#Adam.step``) spans the
            # kernels it launched, idle time between them included
            if not (getattr(evt, "is_user_annotation", False)
                    or evt.name.startswith(("Optimizer.", "ProfilerStep#"))):
                device.append(span)
        elif evt.cpu_parent is None:
            host.append(span)
    device.sort(key=lambda s: s[1])
    host.sort(key=lambda s: s[1])
    return Trace(device, host, wall_s)


def profiled(fn):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activities), ended by
    a synchronize: (what ``fn`` returned, its :class:`Trace`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return out, reduce_events(prof.events(), wall_s)


def idle_gaps(trace: Trace) -> list[tuple[str, float]]:
    """Seconds of device idle time between busy intervals, summed by the
    top-level host operation running at each gap's middle, longest first."""
    busy = merge(trace.spans())
    starts = [s for _, s, _ in trace.host_ops]
    by_op: dict[str, float] = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        k = bisect.bisect_right(starts, mid) - 1
        name = "host between operations"
        # top-level operations of several host threads (the autograd
        # engine's among them) may overlap: take the latest one that covers
        for j in range(k, max(k - 64, -1), -1):
            if trace.host_ops[j][2] >= mid:
                name = trace.host_ops[j][0]
                break
        by_op[name] = by_op.get(name, 0.0) + (start - end) / 1e6
    return sorted(by_op.items(), key=lambda kv: -kv[1])


def breakdown(trace: Trace) -> dict:
    """The line's ``breakdown``: the device operations that took most time
    (summed by name) and the longest idle gaps by host operation."""
    by_name: dict[str, float] = {}
    for name, a, b in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in idle_gaps(trace)[:TOP]]}
