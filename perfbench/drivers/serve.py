"""Driver of the serving cells: one client in a closed loop sends what-if
requests, each a batch of scenarios (seed nodes, beta, gamma) scored through
``cli.infer.predict_summaries`` with the model and adjacency that
``cli.worker.build_model_and_adj`` builds, as ``cli.infer`` serves them.

A request's latency runs from the call to its return (its arrays built with
``cli.infer.scenario_batch`` inside it, its summaries back on the host).
Every request's scenarios and summaries are kept; once the window has
closed, a sample drawn from the seed is scored by the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys

import numpy as np
import torch

from perfbench import faults, harness, inputs, program
from perfbench.reference import gnode as ref


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    graph: dict
    program: dict
    rng: np.random.Generator  # the requests
    sent: list = dataclasses.field(default_factory=list)  # (scenarios, summaries)
    params: dict = None  # the benchmark's copy, for the reference


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    from gn_ode_sir_tpu_torch.cli import worker
    from gn_ode_sir_tpu_torch.graphs.graph import graph_from_edges

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    (graph,) = inputs.graphs(cfg, rng)
    harness.mark("graphs")
    batch = traffic["scenarios_per_request"]
    args = program.worker_args(cfg, batch, device)
    pg = graph_from_edges(graph["n"], graph["pairs"], name=graph["name"])
    model, adj = worker.build_model_and_adj(args, pg, batch_size=batch, device=device)
    program.check_model(model, cfg)
    program.check_adjacency(type(adj).__name__, cfg)
    harness.mark("program")
    params = inputs.gnode_params(inputs.device_generator(seed, device), cfg["model"]["hidden"],
                                 device)
    st = State(cfg=cfg, traffic=traffic, seed=seed, graph=graph,
               program={"model": model, "adj": adj, "params": params},
               rng=np.random.default_rng([seed, 1]),
               params={k: {n: t.clone() for n, t in v.items()} for k, v in params.items()})
    for _ in range(traffic["warmup_requests"]):
        _request(st, keep=False)
    harness.mark("warm-up")
    return st


def _request(st: State, keep: bool = True) -> float:
    """One request, end to end: its latency in seconds."""
    import time

    from gn_ode_sir_tpu_torch.cli import infer

    t = st.cfg["training"]
    b = st.traffic["scenarios_per_request"]
    scen = inputs.trials(st.rng, st.graph["n"], b, t["n_i"], t["beta"], t["gamma"])
    p = st.program
    t0 = time.perf_counter()
    arrays = infer.scenario_batch(st.graph["n"], [s[0] for s in scen], [s[1] for s in scen],
                                  [s[2] for s in scen])
    rows = infer.predict_summaries(p["model"], p["params"], p["adj"], *arrays,
                                   dispatch_batch=st.traffic["dispatch_batch"])
    latency = time.perf_counter() - t0
    if keep:
        st.sent.append((scen, np.array([[r["peak_infected_frac"], r["peak_time"],
                                         r["final_recovered_frac"]] for r in rows])))
    return latency


def _run(st: State, *, seconds=None, requests=None) -> dict:
    clock = harness.Clock(seconds if seconds is not None else float("inf"))
    lat = []
    while not clock.over() and (requests is None or len(lat) < requests):
        lat.append(_request(st))
    bad = sum(1 for _, s in st.sent[-len(lat):] if not np.isfinite(s).all()) if lat else 0
    return {"seconds": clock.elapsed(), "requests": len(lat), "latencies_s": lat,
            "scenarios": len(lat) * st.traffic["scenarios_per_request"], "failed": bad}


def window(st: State, seconds: float) -> dict:
    return _run(st, seconds=seconds)


def traced(st: State) -> dict:
    from gn_ode_sir_tpu_torch.ops.spmm2 import spmm2

    k1 = spmm2.launches
    rec = _run(st, requests=st.traffic["trace_requests"])
    rec["k1_applies"] = spmm2.launches - k1
    return rec


def shapes(st: State) -> list[dict]:
    return [{"n": st.graph["n"], "edges": st.graph["edges"]}]


# At some scenarios the GN-ODE's trajectory amplifies rounding, and any two
# float32 computations of it disagree far beyond float32's rounding (PERF.md,
# "Cells"). A scenario's peak or final fraction is compared only where two
# float32 runs of the reference (the edges in two orders) both lie within
# this of the reference in float64.
NOISE = 1e-6
# Two witnesses do not find every such scenario: at a few that they pass the
# program's float32 result lies tens of times farther out than theirs, which
# PERF.md leaves open. A lower precision moves every scenario, so
# ``final_gap_q90`` reads this quantile of the final recovered gaps, which a
# few scenarios do not reach; ``summary_gap`` keeps the widest gap, for what
# lies in a few scenarios or in the peak.
QUANTILE = 0.9


def check(st: State, rec: dict, limits: dict) -> list[dict]:
    """The reference's summaries of a sample of the requests, drawn from the
    seed, in float64 (the field with K1 and K3, the decoder, the summary
    reduction), over the sampled scenarios where the reference's float32
    runs are within ``NOISE`` of it. ``summary_gap``: the widest of the gaps
    of a peak infected fraction and of a final recovered fraction, and of
    the gap by which the mean infected probability at the program's peak
    time lies below the reference's peak. ``final_gap_q90``: the
    ``QUANTILE`` of the final recovered gaps. Both read inf where a sampled
    summary is not finite, the second also where no scenario is kept."""
    m = st.cfg["model"]
    st.program = None
    torch.cuda.empty_cache()
    device = st.params["enc"]["w"].device
    pick = np.random.default_rng([st.seed, 2]).choice(
        len(st.sent), min(st.traffic["check_requests"], len(st.sent)), replace=False)
    src, dst = (torch.as_tensor(a, device=device) for a in inputs.directed(st.graph["pairs"]))
    params64 = {k: {n: t.double() for n, t in v.items()} for k, v in st.params.items()}
    order = torch.randperm(len(src), generator=torch.Generator().manual_seed(st.seed)).to(device)
    n = st.graph["n"]
    gap, finals, kept, total, finite = 0.0, [], 0, 0, True
    with ref.float32_exact(), torch.no_grad():
        for k in sorted(pick):
            scen, got = st.sent[k]
            b = len(scen)
            finite = finite and bool(np.isfinite(got).all())
            i0 = torch.zeros((b, n), device=device)
            for j, s in enumerate(scen):
                i0[j, s[0]] = 1.0
            rates = torch.tensor([[s[1] for s in scen], [s[2] for s in scen]],
                                 dtype=torch.float32, device=device)
            summary = lambda p_, x, s_, d_: [a.cpu().numpy() for a in ref.summaries(ref.predict(
                p_, s_, d_, 1.0 - x, x, torch.zeros_like(x), *rates.to(x.dtype),
                delta_t=m["delta_t"], max_time=m["max_time"]))]
            want, curve = summary(params64, i0.double(), src, dst)
            witnesses = [summary(st.params, i0, src, dst)[0],
                         summary(st.params, i0, src[order], dst[order])[0]]
            for col in (0, 2):  # peak infected fraction, final recovered fraction
                ok = np.all([np.abs(w[:, col] - want[:, col]) <= NOISE for w in witnesses], 0)
                kept, total = kept + int(ok.sum()), total + b
                if ok.any():
                    gap = max(gap, float(np.abs(got[ok, col] - want[ok, col]).max()))
                if col == 2:
                    finals.extend(np.abs(got[ok, 2] - want[ok, 2]))
            at = got[:, 1].astype(np.int64).clip(0, curve.shape[0] - 1)
            below = want[:, 0] - curve[at, np.arange(b)]
            gap = max(gap, float(below.max()) if (got[:, 1] == at).all() else float("inf"))
    compared = (f"{kept} of {total} peak and final fractions",
                f"{len(finals)} of {total // 2} final recovered fractions")
    print(f"compared: {compared[0]}; {compared[1]}", file=sys.stderr)
    q90 = float(np.quantile(finals, QUANTILE)) if finals and finite else float("inf")
    return [{"name": "summary_gap", "value": gap if finite else float("inf"),
             "limit": limits["summary_gap"], "compared": compared[0]},
            {"name": "final_gap_q90", "value": q90, "limit": limits["final_gap_q90"],
             "compared": compared[1]}]


def attempted(rec: dict) -> tuple[int, int]:
    return rec["requests"], rec["failed"]


# The per-layer metrics that read the spans of this driver's path
# (``tests/test_spans.py``).
SPAN_METRICS = ("forward_ms.serve", "readback_wait_ms.serve")


# --- faults, control and CPU cut (``faults.py``, ``control.py``, ``tests/small.py``)

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def applicable(cfg: dict, traffic: dict) -> tuple:
    return faults.serving_applicable(FAULTS, traffic)


def plant(fault: str):
    """``state_unchanged``: K3 (``gnode_step``, as ``models/gnode.py`` calls
    it) launches and its state is then put back as it was, the label-time
    copy written from it, so the fused forward still runs; ``half_batch``
    and ``answer_altered``: the serving dispatch's (``faults.py``)."""
    from gn_ode_sir_tpu_torch.models import gnode

    if fault == "state_unchanged":
        k3 = gnode.gnode_step

        def held(ai, zs, zi, state, beta, gamma, dt, out=None):
            before = state.clone()
            k3(ai, zs, zi, state, beta, gamma, dt, out=out)
            state.copy_(before)
            if out is not None:
                out.copy_(before.permute(1, 2, 0, 3))

        return faults._patched(gnode, "gnode_step", held)
    if fault == "half_batch":
        return faults.half_dispatch()
    if fault == "answer_altered":
        return faults.late_summary()
    raise ValueError(f"unknown fault {fault!r}")


def control_run(kind: str):
    """What a ``control.py`` reading of ``kind`` runs in (the control: TF32
    on) and the keyword arguments its check takes (none)."""
    return (faults.tf32() if kind == "control" else contextlib.nullcontext()), {}


def cpu_cut(wl: dict, cfg: dict) -> None:
    """K1's plain version, a few requests checked and traced."""
    cfg["model"]["spmm"] = "pallas2"
    wl["traffic"].update(check_requests=4, trace_requests=2)
