"""What the metrics of the program's own spans share.

The program marks the phases of its hot paths with
``gn_ode_sir_tpu_torch.utils.profiling.span``: ``record_function`` ranges
that exist only while a profiler records, side by side, never one inside
another. In the profiled stretch each is a top-level host event, so it is in
``run.trace.host_ops`` on the same clock as the device's operations. A
program without a span (one older than the spans) gives None, never 0.
"""

from __future__ import annotations

from perfbench import profiling


def spans(run, name: str) -> list[tuple[float, float]]:
    """(start_us, end_us) of every top-level host event called ``name`` in
    the profiled stretch."""
    if run.trace is None:
        return []
    return [(a, b) for n, a, b in run.trace.host_ops if n == name]


def per_unit_ms(run, names, unit: str) -> float | None:
    """The summed durations of the spans ``names`` in the profiled stretch,
    ms, over ``run.traced[unit]`` (its steps, requests or calls); None where
    any of the names has no span or the stretch has no unit."""
    found = [spans(run, name) for name in names]
    count = (run.traced or {}).get(unit)
    if not count or not all(found):
        return None
    return sum(b - a for f in found for a, b in f) / 1e3 / count


def overlap_us(a, b) -> float:
    """The measure of the intersection of two sorted lists of disjoint
    intervals (as :func:`perfbench.profiling.merge` gives them)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_within_ms(run, names, unit: str) -> float | None:
    """Device idle ms per ``run.traced[unit]`` inside the spans ``names``:
    the measure of the spans' union less the part of it the union of the
    device's operation spans covers. Every instant counts, the stretch's
    ends included; None where any of the names has no span."""
    found = [spans(run, name) for name in names]
    count = (run.traced or {}).get(unit)
    if not count or not all(found):
        return None
    host = profiling.merge([s for f in found for s in f])
    busy = profiling.merge(run.trace.spans())
    return (profiling.union(host) - overlap_us(host, busy)) / 1e3 / count
