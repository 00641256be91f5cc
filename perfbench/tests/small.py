"""Each cell cut to a size a CPU test run holds: the same drivers, checks
and limits on graphs of tens of nodes. The graphs are cut here; the rest of
the cut (traffic, K1's plain version where the full size takes K1) is the
driver's own ``cpu_cut(wl, cfg)``, where it gives one."""

from __future__ import annotations

import copy

from perfbench import harness

SEED = 3_000_000_017  # beyond 32 signed bits, as the benchmark's seeds are

GRAPHS = [{"name": "a", "nodes": 30, "directed_edges": 80, "role": "train"},
          {"name": "b", "nodes": 50, "directed_edges": 160, "role": "train"},
          {"name": "c", "nodes": 70, "directed_edges": 200, "role": "unseen"}]


def cell(name: str, nodes: int = 60, directed_edges: int = 240) -> tuple[dict, dict]:
    """(workload, config) of cell ``name`` at a small size (a single-graph
    cell on a graph of ``nodes`` and ``directed_edges``; a multi-graph one
    on three graphs, the last unseen)."""
    wl = copy.deepcopy(harness.load_workload(name))
    cfg = copy.deepcopy(harness.load_config(wl["config"]))
    if len(cfg["graphs"]) > 1:
        cfg["graphs"] = copy.deepcopy(GRAPHS)
    else:
        cfg["graphs"][0].update(nodes=nodes, directed_edges=directed_edges)
    cut = getattr(harness.load_module("drivers", wl["driver"]), "cpu_cut", None)
    if cut is not None:
        cut(wl, cfg)
    return wl, cfg
