"""Driver of the DMP serving cells: one client in a closed loop sends what-if
requests, each a batch of scenarios (seed nodes, beta, gamma) scored through
``cli.infer.predict_summaries`` with the DMP model and edge structure that
``cli.worker.build_model_and_adj`` builds for ``--model dmp``, as
``cli.infer --model dmp`` serves them: no parameters, no checkpoint.

A request's latency runs from the call to its return (its arrays built
with ``cli.infer.scenario_batch`` inside it, the dispatch's upload, the
recursion, the summaries back on the host), as in ``drivers/serve.py``.
Every request's scenarios and summaries are kept; once the window has
closed, a sample drawn from the seed is scored by the float64 reference
(``reference/dmp.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

from perfbench import faults, harness, inputs
from perfbench.reference import dmp as ref


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    graph: dict
    program: dict
    rng: np.random.Generator  # the requests
    device: torch.device
    sent: list = dataclasses.field(default_factory=list)  # (scenarios, summaries)


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    from gn_ode_sir_tpu_torch.cli import worker
    from gn_ode_sir_tpu_torch.graphs.graph import graph_from_edges

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    (graph,) = inputs.graphs(cfg, rng)
    harness.mark("graphs")
    m = cfg["model"]
    args = worker.build_parser().parse_args([
        "--model", "dmp", "--maxTime", str(m["max_time"]), "--device", device.type])
    pg = graph_from_edges(graph["n"], graph["pairs"], name=graph["name"])
    model, adj = worker.build_model_and_adj(args, pg, batch_size=traffic["dispatch_batch"],
                                            device=device)
    got = {"family": type(model).__name__, "max_time": model.max_time}
    if got != {"family": "DMPSIR", "max_time": m["max_time"]}:
        raise RuntimeError(f"the program built {got}, the configuration states DMP, "
                           f"max_time {m['max_time']}")
    harness.mark("program")
    st = State(cfg=cfg, traffic=traffic, seed=seed, graph=graph,
               program={"model": model, "adj": adj}, rng=np.random.default_rng([seed, 1]),
               device=device)
    for _ in range(traffic["warmup_requests"]):
        _request(st, keep=False)
    harness.mark("warm-up")
    return st


def _request(st: State, keep: bool = True) -> float:
    """One request, end to end: its latency in seconds."""
    from gn_ode_sir_tpu_torch.cli import infer

    spec = st.cfg["scenarios"]
    scen = inputs.trials(st.rng, st.graph["n"], st.traffic["scenarios_per_request"],
                         spec["n_i"], spec["beta"], spec["gamma"])
    p = st.program
    t0 = time.perf_counter()
    arrays = infer.scenario_batch(st.graph["n"], [s[0] for s in scen], [s[1] for s in scen],
                                  [s[2] for s in scen])
    rows = infer.predict_summaries(p["model"], {}, p["adj"], *arrays,
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


def counters() -> dict:
    """The program's DMP counters, None where the program has none."""
    from gn_ode_sir_tpu_torch.models import dmp
    from gn_ode_sir_tpu_torch.ops.segment import segment_prod

    recursion = getattr(dmp, "dmp_recursion", None)
    return {"edge_updates": getattr(recursion, "edge_updates", None),
            "segment_prod_calls": getattr(segment_prod, "calls", None)}


def traced(st: State) -> dict:
    before = counters()
    rec = _run(st, requests=st.traffic["trace_requests"])
    after = counters()
    for key, value in after.items():
        rec[key] = None if value is None else value - before[key]
    return rec


def shapes(st: State) -> list[dict]:
    return [{"n": st.graph["n"], "edges": st.graph["edges"]}]


def check(st: State, rec: dict, limits: dict) -> list[dict]:
    """The reference's summaries of a sample of the requests, drawn from the
    seed, in float64. ``dmp_summary_gap``: the widest of the gaps of a peak
    infected fraction and of a final recovered fraction, and of the gap by
    which the reference's mean infected probability at the program's peak
    time lies below the reference's peak (inf where that time is no time, or
    where a sampled summary is not finite)."""
    st.program = None
    device = st.device
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pick = np.random.default_rng([st.seed, 2]).choice(
        len(st.sent), min(st.traffic["check_requests"], len(st.sent)), replace=False)
    src, dst = (torch.as_tensor(a, device=device) for a in inputs.directed(st.graph["pairs"]))
    n, max_time = st.graph["n"], st.cfg["model"]["max_time"]
    gap, total = (0.0 if len(pick) else float("inf")), 0
    with torch.no_grad():
        for k in sorted(pick):
            scen, got = st.sent[k]
            b = len(scen)
            if not np.isfinite(got).all():
                gap = float("inf")
            seeds = torch.zeros((b, n), dtype=torch.float64, device=device)
            for j, s in enumerate(scen):
                seeds[j, s[0]] = 1.0
            rates = torch.tensor([[s[1] for s in scen], [s[2] for s in scen]],
                                 dtype=torch.float32, device=device).double()
            probs = ref.predict(src, dst, n, seeds, *rates, max_time=max_time)
            want = ref.summaries(probs).cpu().numpy()
            curve = ref.mean_infected(probs).cpu().numpy()  # [T, B]
            for col in (0, 2):  # peak infected fraction, final recovered fraction
                gap = max(gap, float(np.abs(got[:, col] - want[:, col]).max()))
            at = got[:, 1].astype(np.int64).clip(0, max_time - 1)
            below = want[:, 0] - curve[at, np.arange(b)]
            gap = max(gap, float(below.max()) if (got[:, 1] == at).all() else float("inf"))
            total += b
    print(f"scenarios compared: {total}", file=sys.stderr)
    return [{"name": "dmp_summary_gap", "value": gap, "limit": limits["dmp_summary_gap"]}]


def attempted(rec: dict) -> tuple[int, int]:
    return rec["requests"], rec["failed"]


# The per-layer metrics that read the spans of this driver's path
# (``tests/test_spans.py``).
SPAN_METRICS = ("forward_ms.serve", "readback_wait_ms.serve")


# --- faults, control and CPU cut (``faults.py``, ``control.py``, ``tests/small.py``)

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "backtracking")


def applicable(cfg: dict, traffic: dict) -> tuple:
    return faults.serving_applicable(FAULTS, traffic)


def _on_k4(wrap):
    """K4 (``dmp_step``, as ``models/dmp.py`` calls it) replaced by
    ``wrap(k4)`` for the life of the context: the recursion keeps its fused
    path, so the node product, K5 and K4 still launch."""
    from gn_ode_sir_tpu_torch.models import dmp

    return faults._patched(dmp, "dmp_step", wrap(dmp.dmp_step))


def _held(k4):
    def step(theta, theta_next, *rest):
        k4(theta, theta_next, *rest)
        if theta_next is not None:
            theta_next.copy_(theta)

    return step


def _no_cavity(k4):
    def step(theta, theta_next, phi, ps_ij, pair, w, gamma, src, reverse):
        k4(theta, theta_next, phi, ps_ij, pair, w, gamma, src, torch.full_like(reverse, -1))

    return step


def _bfloat16_state(k4):
    def step(theta, theta_next, phi, ps_ij, *rest):
        k4(theta, theta_next, phi, ps_ij, *rest)
        for x in (theta_next, phi, ps_ij):
            if x is not None:
                x.copy_(x.to(torch.bfloat16))

    return step


def plant(fault: str):
    """``state_unchanged``: theta held, the old theta copied into K4's
    next-theta buffer after each K4; ``backtracking``: K4 given no reverse
    edges, so every edge's cavity factor is 1 and Ps_ij is the source's full
    product; ``half_batch`` and ``answer_altered``: the serving dispatch's
    (``faults.py``)."""
    if fault == "state_unchanged":
        return _on_k4(_held)
    if fault == "backtracking":
        return _on_k4(_no_cavity)
    if fault == "half_batch":
        return faults.half_dispatch()
    if fault == "answer_altered":
        return faults.late_summary()
    raise ValueError(f"unknown fault {fault!r}")


def control_run(kind: str):
    """What a ``control.py`` reading of ``kind`` runs in (the control: the
    edge state, theta, phi and Ps_ij, rounded to bfloat16 after each K4, one
    precision below the configuration's float32) and the keyword arguments
    its check takes (none)."""
    return (_on_k4(_bfloat16_state) if kind == "control" else contextlib.nullcontext()), {}


def cpu_cut(wl: dict, cfg: dict) -> None:
    """A few requests checked and traced."""
    wl["traffic"].update(check_requests=4, trace_requests=2)
