"""Multi-graph training and the baselines of the PyTorch/CUDA port, timed.

    python3 scripts/torch_baselines_profile.py [--steps 10] [--skip_rk_enron]

On one NVIDIA card, on the seeded power-law graphs of ``chip_smoke.py`` at the
published multi-graph run's sizes (dolphins, fb-food, fb-social, openflights,
wiki-vote; enron unseen):

- multi-graph GN-ODE training (hidden 8, batch 8, euler, deltaT 0.5,
  ``--mg_adj auto`` -> K1 on per-graph plans, training at the train view's
  width 7,168): wall ms per step (forward, backward, Adam) by train graph
  (median, 75th percentile, max over ``--steps`` steps) and per evaluation
  pass at the full width 33,696, and ``torch.profiler`` breakdowns of five
  wiki-vote-size steps and of three evaluation passes with K1's launches and
  the device's idle share;
- the same step for GCN (K1 with normalized weights) and GIN (K1 at width 5
  and 8) on the multi-graph connectivity, at hidden 8;
- single-graph GCN and GIN at hidden 64: ms per step at batch 1 on the
  wiki-vote-size graph (dense adjacency) and on the enron-size graph (K1);
- DMP: ``run_many`` on the test split's size (12 trials) at wiki-vote and
  enron size, wall seconds;
- the Runge-Kutta baseline ``sir_classical_batch`` for 2 trials at wiki-vote
  size and, unless ``--skip_rk_enron``, at enron size (256 substeps against a
  4.5 GB f32 adjacency: about a minute), wall seconds beside the bound from
  the adjacency's bytes.

Labels are smooth pseudo-labels from a seed (no simulation: only times are
read). Prints one JSON line per measurement (and writes all of them to
``--out`` when given). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

from chip_smoke import (  # noqa: E402
    HBM_BYTES_PER_S, MAX_TIME, MG_BATCH, MG_HIDDEN, MG_TRAIN_WIDTH, SEED, WIKI, label_trials,
    multigraph_graphs)
from gn_ode_sir_tpu_torch.cli import worker  # noqa: E402
from gn_ode_sir_tpu_torch.graphs import pad_graphs  # noqa: E402
from gn_ode_sir_tpu_torch.models import DMPSIR, GCN, GIN, TimeUnrolledSIR  # noqa: E402
from gn_ode_sir_tpu_torch.ops.spmm2 import spmm2  # noqa: E402
from gn_ode_sir_tpu_torch.sim import classical, sir_classical_batch  # noqa: E402
from gn_ode_sir_tpu_torch.train import (  # noqa: E402
    build_trial_data, l1_sir_loss, multigraph_auto_fns, multigraph_split)
from gn_ode_sir_tpu_torch.train.checkpoint import tree_leaves, tree_map  # noqa: E402
from gn_ode_sir_tpu_torch.train.loop import (  # noqa: E402
    _data_to_device, make_eval_fn, make_train_epoch_fn)
from torch_train_profile import _profiled  # noqa: E402

TRIALS_PER_GRAPH = 8


def pseudo_trials(graphs, per_graph: int, n_pad=None):
    """``per_graph`` trials a graph with smooth pseudo-labels from a seed:
    (TrialData, graph ids)."""
    rng = np.random.default_rng([SEED, 5])
    nodes, triples, gidx = [], [], []
    for g_i, g in enumerate(graphs):
        for _ in range(per_graph):
            nodes.append(sorted(rng.choice(g.n_nodes, 3, replace=False).tolist()))
            p = rng.dirichlet([2.0, 1.0, 1.0], size=(MAX_TIME, g.n_nodes)).astype(np.float32)
            triples.append((p[..., 0], p[..., 1], p[..., 2]))
            gidx.append(g_i)
    total = len(nodes)
    width = n_pad or graphs[0].n_nodes
    return build_trial_data(width, nodes, rng.uniform(0.1, 0.5, total),
                            rng.uniform(0.05, 0.3, total), triples, graph_idx=gidx, n_pad=n_pad)


def wall_stats(fn, steps: int) -> dict:
    """Wall ms of ``fn`` over ``steps`` calls, each ending in a synchronise."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    q = statistics.quantiles(walls, n=4)
    return {"ms_median": statistics.median(walls), "ms_p75": q[2], "ms_max": max(walls)}


def trainer(model, conn, lr=1e-3):
    """(params, step(d, rows)): one Adam step on the minibatch ``rows``."""
    params = tree_map(lambda t: t.requires_grad_(True),
                      model.init(torch.Generator().manual_seed(SEED), device="cuda"))
    opt = torch.optim.Adam([leaf for _, leaf in tree_leaves(params)], lr=lr)
    epoch = make_train_epoch_fn(model, opt, conn.adj_fn, conn.node_mask_fn,
                                n_view=getattr(conn.adj_fn, "n_view", None))
    return params, lambda d, rows: epoch(params, d, rows, np.ones(rows.shape, np.float32))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--skip_rk_enron", action="store_true")
    p.add_argument("--out", default=None, help="also write the records to this JSON file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    emit({"card": card, "torch": torch.__version__})
    graphs = multigraph_graphs()
    wiki, enron = graphs[WIKI], graphs[-1]

    # multi-graph training: per-graph step, evaluation pass, profiles
    batch = pad_graphs(graphs)
    data = pseudo_trials(graphs, TRIALS_PER_GRAPH, n_pad=batch.n_max)
    d = _data_to_device(data, "cuda")
    tr, va, te = multigraph_split([TRIALS_PER_GRAPH] * len(graphs))
    rows_of = lambda g_i: tr[data.graph_idx[tr] == g_i][None, :MG_BATCH]
    eval_rows = np.concatenate([va, te])[None, :MG_BATCH]
    wargs = worker.build_parser().parse_args(
        ["--hidden", str(MG_HIDDEN), "--batch_size", str(MG_BATCH), "--device", "cuda"])
    gnn = dict(hidden_dim=MG_HIDDEN, penultimate_dim=MG_HIDDEN // 2, window=MAX_TIME)
    for family, model, gcn_norm in (
            ("ode_nn", worker.build_model(wargs, batch.n_max), False),
            ("GCN", TimeUnrolledSIR(GCN(**gnn)), True),
            ("GIN", TimeUnrolledSIR(GIN(**gnn)), False)):
        conn = multigraph_auto_fns(batch, gcn_normalized=gcn_norm, device="cuda")
        if (conn.kind, conn.adj_fn.n_view) != ("pallas2", MG_TRAIN_WIDTH):
            raise AssertionError(f"auto gave {conn.kind} at width {conn.adj_fn.n_view}")
        params, step = trainer(model, conn)
        evaluate = make_eval_fn(model, conn.eval_adj_fn, conn.node_mask_fn)
        torch.cuda.reset_peak_memory_stats()
        for g_i, g in enumerate(graphs[:-1]):
            if family != "ode_nn" and g_i != WIKI:
                continue
            rows = rows_of(g_i)
            emit({"measure": "mg_train_step", "model": family, "graph": g.name,
                  "n": g.n_nodes, "edges": g.n_edges, "width": conn.adj_fn.n_view,
                  "batch": MG_BATCH, "hidden": MG_HIDDEN,
                  **wall_stats(lambda: step(d, rows), args.steps)})
        emit({"measure": "mg_eval_pass", "model": family, "graph": enron.name,
              "width": batch.n_max, "batch": MG_BATCH,
              **wall_stats(lambda: evaluate(params, d, eval_rows, np.ones((1, MG_BATCH), np.float32)),
                           args.steps),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        rows = rows_of(WIKI)
        fwd0, bwd0 = spmm2.launches, spmm2.backward_launches
        prof = _profiled(lambda: step(d, rows), 5)
        emit({"measure": "mg_train_profile", "model": family, "graph": wiki.name,
              "profiled_steps": 5, "k1_launches": spmm2.launches - fwd0,
              "k1_backward_launches": spmm2.backward_launches - bwd0, **prof})
        if family == "ode_nn":
            fwd0 = spmm2.launches
            prof = _profiled(
                lambda: evaluate(params, d, eval_rows, np.ones((1, MG_BATCH), np.float32)), 3)
            emit({"measure": "mg_eval_profile", "model": family, "graph": enron.name,
                  "profiled_passes": 3, "k1_launches": spmm2.launches - fwd0, **prof})
        del params, conn
    del d, data
    torch.cuda.empty_cache()

    # single-graph GCN and GIN at hidden 64, batch 1: dense below 8,192 nodes, K1 above
    for g in (wiki, enron):
        data = pseudo_trials([g], 1)
        xs = tuple(torch.as_tensor(a, device="cuda")
                   for a in (data.s0, data.i0, data.r0, data.beta, data.gamma))
        labels = torch.as_tensor(data.labels, device="cuda")
        for family in ("GCN", "GIN"):
            wargs = worker.build_parser().parse_args(
                ["--model", family, "--hidden", "64", "--batch_size", "1", "--device", "cuda"])
            model, adj = worker.build_model_and_adj(wargs, g)
            params = tree_map(lambda t: t.requires_grad_(True),
                              model.init(torch.Generator().manual_seed(SEED), device="cuda"))
            opt = torch.optim.Adam([leaf for _, leaf in tree_leaves(params)], lr=1e-3)
            gen = torch.Generator(device="cuda").manual_seed(SEED)

            def step():
                opt.zero_grad(set_to_none=True)
                l1_sir_loss(model.predict(params, adj, *xs, rng=gen, train=True), labels).backward()
                opt.step()

            torch.cuda.reset_peak_memory_stats()
            fwd0, bwd0 = spmm2.launches, spmm2.backward_launches
            stats = wall_stats(step, args.steps)
            emit({"measure": "gnn_train_step", "model": family, "graph": g.name, "n": g.n_nodes,
                  "hidden": 64, "batch": 1, "adjacency": type(adj).__name__, **stats,
                  "k1_launches_per_step": (spmm2.launches - fwd0) // (args.steps + 2),
                  "k1_backward_per_step": (spmm2.backward_launches - bwd0) // (args.steps + 2),
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
            if g is enron:
                emit({"measure": "gnn_train_profile", "model": family, "graph": g.name,
                      "profiled_steps": 3, **_profiled(step, 3)})
            del params, adj, opt
        torch.cuda.empty_cache()

    # DMP and RK: wall seconds of the batched baselines
    for g in (wiki, enron):
        trials = (label_trials(g) * 2)[:12]
        dmp = DMPSIR.from_graph(g)
        run = lambda: dmp.run_many([t[0] for t in trials], [t[1] for t in trials],
                                   [t[2] for t in trials], max_time=MAX_TIME, device="cuda")
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        emit({"measure": "dmp_run_many", "graph": g.name, "n": g.n_nodes, "edges": g.n_edges,
              "trials": len(trials), "seconds": time.perf_counter() - t0,
              "finite": bool(torch.isfinite(out).all())})
    for g in (wiki, enron):
        if g is enron and args.skip_rk_enron:
            continue
        trials = label_trials(g)[:2]
        betas, gammas = [t[1] for t in trials], [t[2] for t in trials]
        substeps = classical.auto_substeps(g, betas, max(gammas), 0.5)
        t0 = time.perf_counter()
        i_b, s_b, r_b = sir_classical_batch(g, [t[0] for t in trials], betas, gammas,
                                            max_time=MAX_TIME, device="cuda")
        seconds = time.perf_counter() - t0
        products = (2 * MAX_TIME - 1) * substeps * 4  # rk4: four field evaluations a substep
        emit({"measure": "rk_batch", "graph": g.name, "n": g.n_nodes, "trials": len(trials),
              "max_degree": int(g.degrees.max()), "substeps": substeps, "products": products,
              "seconds": seconds,
              "bound_s_adjacency_bytes": products * g.n_nodes ** 2 * 4 / HBM_BYTES_PER_S,
              "sum_to_one_err": float(np.abs(i_b + s_b + r_b - 1).max()),
              "finite": bool(np.isfinite(i_b).all())})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
