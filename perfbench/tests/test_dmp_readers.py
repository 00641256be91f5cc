"""``dmp_roofline.serve`` and ``segment_prod_share.serve`` on synthetic
traces: the recursion's kernels between a dispatch's upload and its
summary's first reduction, the least bytes over their union, the node
product's share of it; None off the card, without the program's counters,
or where the counters, the traffic and the trace disagree."""

from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.counts import dmp as counts
from perfbench.profiling import Trace

N, E, STEPS = 10, 40, 3
SCATTER = ("void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::"
           "_cuda_scatter_gather_internal_kernel<true, float, long>::operator()"
           "<at::native::ReduceMultiply>(at::TensorIterator&, long, long, long, float const&)")
GATHER = SCATTER.replace("true, float", "false, at::native::OpaqueType<4>").replace(
    "ReduceMultiply", "TensorAssign")


def _dispatch(t0):
    """One dispatch's device operations from ``t0`` (us): the upload, per
    step a gather (10 us, the kernel template the scatter shares), an
    elementwise op (20 us) and the scatter (30 us), then the summary and
    the readback."""
    ops = [("Memcpy HtoD (Pageable -> Device)", t0, t0 + 5),
           ("Memcpy HtoD (Pageable -> Device)", t0 + 5, t0 + 8)]
    t = t0 + 10
    for _ in range(STEPS):
        ops += [(GATHER, t, t + 10),
                ("vectorized_elementwise_kernel<4, MulFunctor>", t + 10, t + 30),
                (SCATTER, t + 30, t + 60)]
        t += 60
    ops += [("reduce_kernel<512, 1, MeanOps>", t, t + 7),
            ("vectorized_elementwise_kernel<4, CompareEq>", t + 7, t + 8),
            ("Memcpy DtoH (Device -> Pageable)", t + 9, t + 10)]
    return ops


def _run(requests=2, edge_updates=None, calls=None, trace=True):
    ops = [op for k in range(requests) for op in _dispatch(1000 * k)]
    per = 4
    traced = {"requests": requests,
              "edge_updates": requests * per * E * STEPS if edge_updates is None else edge_updates,
              "segment_prod_calls": requests * STEPS if calls is None else calls}
    return SimpleNamespace(
        cfg={"model": {"max_time": STEPS + 1}},
        traffic={"scenarios_per_request": per, "dispatch_batch": per},
        shapes=[{"n": N, "edges": E}], traced=traced, on_card=trace,
        trace=Trace(ops, [], 0.01) if trace else None)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_roofline_and_share_from_the_recursion_kernels():
    run = _run()
    busy_s = 2 * STEPS * 60e-6  # gathers, elementwise ops and scatters; no copy or summary
    bound = counts.least_bytes(N, E, 4, STEPS) * 2 / 3.35e12
    assert _read("dmp_roofline.serve", run) == pytest.approx(100 * bound / busy_s)
    assert _read("segment_prod_share.serve", run) == pytest.approx(50.0)


@pytest.mark.parametrize("case", [
    dict(trace=False),  # off the card
    dict(edge_updates=None, calls=None, requests=0),  # nothing traced
    dict(edge_updates=1),  # the counter disagrees with the traffic
    dict(calls=5),  # segment_prod.calls disagrees with the steps
])
def test_none_where_nothing_or_disagreement(case):
    run = _run(**case)
    assert _read("dmp_roofline.serve", run) is None
    assert _read("segment_prod_share.serve", run) is None


def test_none_without_the_counters():
    """A program without ``dmp_recursion.edge_updates`` (the parent of the
    change that added it) or without ``segment_prod.calls``."""
    for key in ("edge_updates", "segment_prod_calls"):
        run = _run()
        run.traced[key] = None
        assert _read("dmp_roofline.serve", run) is None
        assert _read("segment_prod_share.serve", run) is None


def test_none_where_the_trace_lost_a_scatter():
    run = _run()
    lost = [op for op in run.trace.device_ops if op[0] == SCATTER][0]
    run.trace.device_ops.remove(lost)
    assert _read("dmp_roofline.serve", run) is None
    assert _read("segment_prod_share.serve", run) is None
