"""What the DMP metrics share: the recursion's part of a traced serving
stretch, and its cross-checks against the program's counters.

A dispatch's device operations come in stream order: the scenario arrays'
host-to-device copies, the recursion, the summary reduction (it opens with
a ``reduce_kernel``, the mean infected probability over the nodes), the
summaries' copy back. The recursion's operations are the kernels from the
first after a host-to-device copy to the last before the next
``reduce_kernel``: fills, gathers, elementwise ops, the node product's
scatter and the marginals' stack. ``segment_prod``'s kernel is the
scatter-reduce, one a call: PyTorch's ``_scatter_gather_elementwise_kernel``
with ``ReduceMultiply`` (the same template with ``TensorAssign`` is the
gathers of ``index_select``).
"""

from __future__ import annotations

import sys

from perfbench import profiling
from perfbench.counts import dmp as counts


def is_segment_prod(name: str) -> bool:
    return "_scatter_gather_elementwise_kernel" in name and "ReduceMultiply" in name


def recursion_ops(trace) -> list:
    """(name, start_us, end_us) of the recursion's kernels, in order."""
    out, inside = [], False
    for op in trace.device_ops:
        name = op[0]
        if name.startswith("Memcpy HtoD"):
            inside = True
        elif "reduce_kernel" in name:
            inside = False
        elif inside and not name.startswith(("Memcpy", "Memset")):
            out.append(op)
    return out


def recursion(run) -> dict | None:
    """The traced stretch's recursion: its device seconds (union of its
    kernels' spans), its ``segment_prod`` kernels' seconds and count, the
    edge updates and steps it ran; None off the card, without the program's
    counters, or where they disagree with the trace or the traffic."""
    rec = run.traced or {}
    if run.trace is None or rec.get("edge_updates") is None or not rec.get("requests"):
        return None
    steps = run.cfg["model"]["max_time"] - 1
    per, cap = run.traffic["scenarios_per_request"], run.traffic["dispatch_batch"]
    dispatches = rec["requests"] * -(-per // cap)
    g = run.shapes[0]
    ops = recursion_ops(run.trace)
    seg = [op for op in ops if is_segment_prod(op[0])]
    want = {"edge_updates": rec["requests"] * per * g["edges"] * steps,
            "segment_prod": dispatches * steps}
    got = {"edge_updates": rec["edge_updates"], "segment_prod": rec.get("segment_prod_calls")}
    if got != want or len(seg) != want["segment_prod"]:
        print(f"DMP recursion: counted {got}, {len(seg)} segment_prod kernels in the trace, "
              f"expected {want}", file=sys.stderr)
        return None
    return {"busy_s": profiling.union([(a, b) for _, a, b in ops]) / 1e6,
            "segment_prod_s": profiling.union([(a, b) for _, a, b in seg]) / 1e6,
            "bound_s": counts.bound_s(rec["edge_updates"], g["n"], g["edges"], steps)}
