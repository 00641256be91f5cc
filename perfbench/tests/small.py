"""Each cell cut to a size a CPU test run holds: the same drivers, checks
and limits on graphs of tens of nodes, K1's plain version forced where the
full size takes K1."""

from __future__ import annotations

import copy

from perfbench import harness

SEED = 3_000_000_017  # beyond 32 signed bits, as the benchmark's seeds are


def cell(name: str, nodes: int = 60, directed_edges: int = 240) -> tuple[dict, dict]:
    """(workload, config) of cell ``name`` at a small size (a single-graph
    cell on a graph of ``nodes`` and ``directed_edges``)."""
    wl = copy.deepcopy(harness.load_workload(name))
    cfg = copy.deepcopy(harness.load_config(wl["config"]))
    cfg["model"]["spmm"] = "pallas2"
    t = wl["traffic"]
    if len(cfg["graphs"]) > 1:
        cfg["graphs"] = [{"name": "a", "nodes": 30, "directed_edges": 80, "role": "train"},
                         {"name": "b", "nodes": 50, "directed_edges": 160, "role": "train"},
                         {"name": "c", "nodes": 70, "directed_edges": 200, "role": "unseen"}]
        cfg["model"]["mg_adj"] = "pallas2"
        t.update(trials_per_graph=10, steps_per_call=3, first_steps=2, check_call_within=2,
                 trace_steps=4)
    else:
        cfg["graphs"][0].update(nodes=nodes, directed_edges=directed_edges)
        cfg["labels"]["sims"] = 64
        for key, value in dict(trials_per_graph=6, steps_per_call=4, trace_steps=3,
                               first_steps=2, check_call_within=2,
                               trials_per_call=3, check_trials=2, check_requests=4,
                               trace_requests=2).items():
            if key in t:
                t[key] = value
    return wl, cfg
