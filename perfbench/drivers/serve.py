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

import dataclasses
import sys

import numpy as np
import torch

from perfbench import harness, inputs, program
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
# "Cells"). A scenario's summary is compared only where two float32 runs of
# the reference (the edges in two orders) both lie within this of the
# reference in float64.
NOISE = 1e-6


def check(st: State, rec: dict, limits: dict) -> list[dict]:
    """The reference's summaries of a sample of the requests, drawn from the
    seed, in float64. ``summary_gap``: the widest of the gaps of a peak
    infected fraction and of a final recovered fraction (each where the
    reference's float32 runs are within ``NOISE`` of it) and of the gap by
    which the mean infected probability at the program's peak time lies
    below the reference's peak."""
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
    gap, kept, total = 0.0, 0, 0
    with ref.float32_exact(), torch.no_grad():
        for k in sorted(pick):
            scen, got = st.sent[k]
            b = len(scen)
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
            at = got[:, 1].astype(np.int64).clip(0, curve.shape[0] - 1)
            below = want[:, 0] - curve[at, np.arange(b)]
            gap = max(gap, float(below.max()) if (got[:, 1] == at).all() else float("inf"))
    print(f"summaries compared: {kept} of {total}", file=sys.stderr)
    return [{"name": "summary_gap", "value": gap, "limit": limits["summary_gap"]}]


def attempted(rec: dict) -> tuple[int, int]:
    return rec["requests"], rec["failed"]
