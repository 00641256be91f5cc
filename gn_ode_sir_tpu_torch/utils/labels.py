"""Label cache — per-trial SIR label pickles (port of
``gn_ode_sir_tpu.utils.labels``).

Same on-disk contract as the JAX package, so a cache written by either
package loads in the other: files ``<graph>-{S,I,R}-<i1>-<i2>[-b<beta>-g<gamma>].pkl``
holding [max_time, n] float64 probability arrays. New labels are WRITTEN
under the (seeds, beta, gamma)-tagged name (two trials that share a seed set
but differ in rates must not collide); reads try that name first and fall
back to the reference's seeds-only name.

Some reference datasets were cached as raw indicator COUNTS and divided by
``sim`` at load time: values above 1.5 cannot be probabilities, so they are
divided by ``sim``.

Where the JAX package takes PRNG keys, this one takes integer seeds.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np


def label_paths(save_dir: str, graph_name: str, seed_nodes,
                beta: float | None = None, gamma: float | None = None) -> dict:
    """Pickle paths for one trial. With ``beta``/``gamma`` given, the name
    carries the full trial key; without, the reference's seeds-only name."""
    tag = "-".join(str(int(i)) for i in seed_nodes)
    if beta is not None and gamma is not None:
        tag = f"{tag}-b{float(beta):.6g}-g{float(gamma):.6g}"
    return {
        c: os.path.join(save_dir, f"{graph_name}-{c}-{tag}.pkl") for c in ("S", "I", "R")
    }


def load_labels(save_dir: str, graph_name: str, seed_nodes, sim: int | None = None,
                beta: float | None = None, gamma: float | None = None):
    """Load a cached (S, I, R) label triple; returns None on cache miss.

    With ``beta``/``gamma`` given, the exact-keyed name is tried first, then
    the legacy seeds-only name (reference compatibility).
    """
    paths = None
    if beta is not None and gamma is not None:
        exact = label_paths(save_dir, graph_name, seed_nodes, beta, gamma)
        if all(os.path.exists(p) for p in exact.values()):
            paths = exact
    if paths is None:
        paths = label_paths(save_dir, graph_name, seed_nodes)
        if not all(os.path.exists(p) for p in paths.values()):
            return None
    out = []
    for c in ("S", "I", "R"):
        with open(paths[c], "rb") as f:
            arr = np.asarray(pickle.load(f), dtype=np.float64)
        if arr.max() > 1.5:  # stored as counts (wiki-vote/enron convention)
            if not sim:
                raise ValueError(f"{paths[c]} stored as counts but sim not given")
            arr = arr / float(sim)
        out.append(arr)
    return tuple(out)


def load_or_extract_labels(
    graph,
    seed_nodes,
    beta: float,
    gamma: float,
    *,
    sim: int = 10000,
    max_time: int = 20,
    save_dir: str | None = None,
    seed: int = 0,
    sims_chunk: int | None = None,
    coins: str = "auto",
    matmul: str = "auto",
    device,
):
    """Cache-or-simulate for one trial; the simulation runs on ``device``."""
    if save_dir is not None:
        cached = load_labels(save_dir, graph.name, seed_nodes, sim, beta, gamma)
        if cached is not None:
            return cached

    from gn_ode_sir_tpu_torch.sim import simulate_sir

    s, i, r = simulate_sir(
        graph, seed_nodes, beta, gamma, sims=sim, max_time=max_time, seed=seed,
        sims_chunk=sims_chunk, coins=coins, matmul=matmul, device=device)
    if save_dir is not None:
        _record_coin_mode(save_dir, coins)
        _write_labels(save_dir, graph.name, seed_nodes, beta, gamma, (s, i, r))
    return s, i, r


def _record_coin_mode(save_dir: str, coins: str) -> None:
    """Persist the RESOLVED coin mode next to the label cache, and say so
    loudly when a later extraction into the same cache uses another mode
    (this package's or the JAX package's): the cache then mixes MC streams."""
    from gn_ode_sir_tpu_torch.sim.mc_sir import _resolve_coins

    resolved = _resolve_coins(coins)
    os.makedirs(save_dir, exist_ok=True)
    meta_path = os.path.join(save_dir, "coins-mode.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            prev = json.load(f)
        if prev.get("coins") != resolved:
            print(
                f"[labels] WARNING: cache {save_dir} was extracted with "
                f"coins={prev.get('coins')!r} but this run uses "
                f"coins={resolved!r}; cached and fresh labels mix MC streams "
                f"(both valid estimates, but the cache is no longer "
                f"single-mode reproducible)"
            )
        return
    with open(meta_path, "w") as f:
        json.dump({"coins": resolved, "note": (
            "resolved RNG mode used for cache-miss label extraction; "
            "philox16 (one Philox4x32-10 word per node and step) is "
            "reproducible from the trial's integer seed"
        )}, f, indent=2)


def _write_labels(save_dir, graph_name, seed_nodes, beta, gamma, triple):
    os.makedirs(save_dir, exist_ok=True)
    # write under the exact (seeds, beta, gamma) key: the seeds-only
    # reference name collides across trials sharing a seed set
    paths = label_paths(save_dir, graph_name, seed_nodes, beta, gamma)
    for c, arr in zip(("S", "I", "R"), triple):
        with open(paths[c], "wb") as f:
            pickle.dump(arr, f)


def load_or_extract_labels_many(
    graph,
    trials,
    *,
    sim: int = 10000,
    max_time: int = 20,
    save_dir: str | None = None,
    seeds=None,
    sims_chunk: int | None = None,
    coins: str = "auto",
    matmul: str = "auto",
    device,
):
    """Batched cache-or-simulate over a trial list [(seed nodes, beta, gamma)].

    Cache hits load from disk; ALL misses are simulated together through
    :func:`gn_ode_sir_tpu_torch.sim.simulate_sir_many` (several trials per
    dispatch). ``seeds`` gives one integer seed per trial, aligned with
    ``trials``; every miss draws the stream the one-trial path would draw
    under its seed. With ``sims_chunk`` set (the huge-graph regime) misses
    run one trial at a time, chunked over simulations.
    """
    from gn_ode_sir_tpu_torch.sim import simulate_sir, simulate_sir_many
    from gn_ode_sir_tpu_torch.sim.mc_sir import fold_seed

    triples: list = [None] * len(trials)
    missing: list[int] = []
    for j, (nodes, beta, gamma) in enumerate(trials):
        cached = (
            load_labels(save_dir, graph.name, nodes, sim, beta, gamma)
            if save_dir is not None else None
        )
        if cached is not None:
            triples[j] = cached
        else:
            missing.append(j)
    if missing:
        if save_dir is not None:
            _record_coin_mode(save_dir, coins)
        # without seeds, every miss still gets a DISTINCT stream: the
        # schedule simulate_sir_many defaults to
        miss_seeds = ([fold_seed(0, 1000 + pos) for pos in range(len(missing))]
                      if seeds is None else [seeds[j] for j in missing])
        if sims_chunk is not None:
            fresh = [
                simulate_sir(graph, *trials[j][:3], sims=sim, max_time=max_time,
                             seed=ms, sims_chunk=sims_chunk, coins=coins,
                             matmul=matmul, device=device)
                for j, ms in zip(missing, miss_seeds)
            ]
        else:
            fresh = simulate_sir_many(
                graph, [trials[j] for j in missing], sims=sim, max_time=max_time,
                seeds=miss_seeds, coins=coins, matmul=matmul, device=device)
        for j, triple in zip(missing, fresh):
            triples[j] = triple
            if save_dir is not None:
                nodes, beta, gamma = trials[j]
                _write_labels(save_dir, graph.name, nodes, beta, gamma, triple)
    return triples
