"""Driver of the label cells: back-to-back calls of ``sim.simulate_sir_many``
(the program chooses its trial chunks, the int8 count product and K2), each
call ``trials_per_call`` trials of ``sims`` simulations with seeds, rates
and seed nodes from the run's seed.

Set-up builds the graph and runs one short call at the window's chunk
shape, which builds the dense int8 adjacency and loads the kernels. Every
call's per-node (S, I, R) comes back to the host; once the window has
closed, a sample of trials drawn from the seed is replayed by the
reference, which draws the same coin words.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import harness, inputs
from perfbench.reference import mc_sir as ref


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    graph: dict
    program: dict
    rng: np.random.Generator
    done: list = dataclasses.field(default_factory=list)  # (trial, seed, (S, I, R))


def setup(cfg: dict, traffic: dict, seed: int, device) -> State:
    from gn_ode_sir_tpu_torch.graphs.graph import graph_from_edges
    from gn_ode_sir_tpu_torch.sim import mc_sir

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    (graph,) = inputs.graphs(cfg, rng)
    pg = graph_from_edges(graph["n"], graph["pairs"], name=graph["name"])
    harness.mark("graphs")
    st = State(cfg=cfg, traffic=traffic, seed=seed, graph=graph,
               program={"graph": pg, "device": device}, rng=np.random.default_rng([seed, 1]))
    # one call of one chunk and one step: the adjacency, the product's
    # shape and the kernels, as the window's chunks will take them
    sims = cfg["labels"]["sims"]
    per_call = traffic["trials_per_call"]
    chunk = mc_sir.balanced_chunk(per_call, mc_sir.auto_trials_chunk(pg.n_nodes, sims, device))
    warm = _trials(st, chunk)
    mc_sir.simulate_sir_many(pg, [t for t, _ in warm], sims=sims, max_time=2,
                             seeds=[s for _, s in warm], device=device)
    harness.mark("warm-up")
    return st


def _trials(st: State, count: int) -> list:
    lab = st.cfg["labels"]
    scen = inputs.trials(st.rng, st.graph["n"], count, lab["n_i"], lab["beta"], lab["gamma"])
    seeds = st.rng.integers(0, inputs.MAX_SEED, count, dtype=np.int64, endpoint=True)
    return [(s, int(k)) for s, k in zip(scen, seeds)]


def _call(st: State) -> None:
    from gn_ode_sir_tpu_torch.sim import mc_sir

    lab = st.cfg["labels"]
    todo = _trials(st, st.traffic["trials_per_call"])
    out = mc_sir.simulate_sir_many(st.program["graph"], [t for t, _ in todo], sims=lab["sims"],
                                   max_time=lab["max_time"], seeds=[s for _, s in todo],
                                   device=st.program["device"])
    st.done.extend((t, s, sir) for (t, s), sir in zip(todo, out))


def _run(st: State, *, seconds=None, calls=None) -> dict:
    clock = harness.Clock(seconds if seconds is not None else float("inf"))
    n_calls, first = 0, len(st.done)
    while not clock.over() and (calls is None or n_calls < calls):
        _call(st)
        n_calls += 1
    bad = sum(1 for _, _, sir in st.done[first:] if not all(np.isfinite(a).all() for a in sir))
    return {"seconds": clock.elapsed(), "calls": n_calls,
            "trials": n_calls * st.traffic["trials_per_call"],
            "sims": n_calls * st.traffic["trials_per_call"] * st.cfg["labels"]["sims"],
            "failed": bad}


def window(st: State, seconds: float) -> dict:
    return _run(st, seconds=seconds)


def traced(st: State) -> dict:
    return _run(st, calls=st.traffic["trace_calls"])


def shapes(st: State) -> list[dict]:
    return [{"n": st.graph["n"], "edges": st.graph["edges"]}]


def check(st: State, rec: dict, limits: dict, control: bool = False) -> list[dict]:
    """The reference's replay of a sample of the trials, drawn from the
    seed: the widest gap of a per-node probability, and the widest gap of a
    node's mean over time (a bias that the widest gap may hide).
    ``control``: the reference with bfloat16 thresholds stands in the
    program's place (``perfbench/control.py``)."""
    lab = st.cfg["labels"]
    device = st.program["device"]
    st.program = None  # the graph, and with it the program's cached adjacency
    torch.cuda.empty_cache()
    pick = np.random.default_rng([st.seed, 2]).choice(
        len(st.done), min(st.traffic["check_trials"], len(st.done)), replace=False)
    src, dst = inputs.directed(st.graph["pairs"])
    a = ref.adjacency(src, dst, st.graph["n"], device)
    worst, bias = 0.0, 0.0
    for k in sorted(pick):
        (nodes, beta, gamma), seed, got = st.done[k]
        replay = lambda precision: ref.simulate(a, nodes, beta, gamma, seed, sims=lab["sims"],
                                                max_time=lab["max_time"], precision=precision)
        got = replay("bf16") if control else np.stack(got)
        diff = got - replay("f32")  # [3, T, n]
        worst = max(worst, float(np.abs(diff).max()))
        bias = max(bias, float(np.abs(diff.mean(axis=1)).max()))
    values = {"prob_gap": worst, "mean_gap": bias}
    return [{"name": k, "value": v, "limit": limits[k]} for k, v in values.items()]


def attempted(rec: dict) -> tuple[int, int]:
    return rec["trials"], rec["failed"]
