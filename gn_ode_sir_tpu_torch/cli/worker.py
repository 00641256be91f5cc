"""Experiment worker — the CLI entry point for one experiment run (port of
``gn_ode_sir_tpu.cli.worker``), with the same flags and defaults as the JAX
worker plus ``--device``:

  python -m gn_ode_sir_tpu_torch.cli.worker --dataset ./real_graphs/karate \\
      --model ode_nn --hidden 64 --epochs 500 --lr 1e-4 --batch_size 1 \\
      --I_indices "[25, 18]" "[1, 27]" --beta 0.47 0.26 --gamma 0.31 0.33 \\
      --path_to_save ./experiments/karate

What it runs: ``--model ode_nn|GCN|GIN`` on a single graph, with and
without ``--out_of_dist``, and on a ``+``-joined multi-graph dataset (train
on all graphs but the last, evaluate on the unseen last one; ``--mg_adj``,
``--mg_precision``, ``--instances_per_graph``) — Monte-Carlo labels on cache
miss, training, the reference-schema CSV row, and ``--save_checkpoint`` (a
``serve.pt`` that ``cli.infer --ckpt`` scores); ``--ensemble K`` (K repeats
in one run, ``train/ensemble.py``, K CSV rows for trials ``--trial`` +
j); ``--node_split`` (the legacy transductive protocol on the first trial);
periodic checkpoints and resume (``--checkpoint_every``, ``--resume``,
``--auto_checkpoint``) and the ``--die_at_epoch`` crash drill; the solver
options ``--method dopri5_adaptive`` and ``--adjoint backsolve``; the
closed-form baselines ``--model dmp`` and ``--model rk``, and
``--rk_baseline``, which fills the ``loss_baseline`` and ``rk_time``
columns. The model and adjacency construction is shared with ``cli.infer``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import time

import numpy as np
import torch


def parse_i_indices(raw) -> list[list[int]]:
    """Accept both the reference's list-strings ('[25, 18]') and plain comma
    forms ('25,18')."""
    out = []
    for item in raw:
        s = str(item).strip().strip("[]")
        parts = [p for p in s.replace(",", " ").split() if p]
        out.append([int(p) for p in parts])
    return out


def resolve_device(name: str) -> torch.device:
    """``--device`` -> torch.device. 'cuda' without a visible card raises:
    the port never carries on on the CPU unless asked to."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: torch.cuda.is_available() is False on this machine; "
            "pass --device cpu to run on the CPU")
    return torch.device(name)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GN-ODE SIR experiment worker (PyTorch/CUDA port)")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--sim", type=int, default=1000)
    p.add_argument("--beta", type=float, nargs="+", default=[0.2])
    p.add_argument("--gamma", type=float, nargs="+", default=[0.1])
    p.add_argument("--deltaT", type=float, default=0.5)
    p.add_argument("--maxTime", type=int, default=20)
    p.add_argument("--I_indices", nargs="+", default=["12"])
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--path_to_save", default="./experiments")
    p.add_argument("--trial", type=int, default=1)
    p.add_argument("--dataset", default="none")
    p.add_argument("--train_val_test_ratio", nargs=3, type=float, default=[0.6, 0.2, 0.2])
    p.add_argument("--model", default="ode_nn", choices=["ode_nn", "GCN", "GIN", "dmp", "rk"])
    p.add_argument("--out_of_dist", default=False, action="store_true")
    p.add_argument("--method", default="euler",
                   help="ODE solver (euler/midpoint/rk4/dopri5/dopri5_adaptive)")
    p.add_argument("--adjoint", default="auto",
                   help="auto|checkpoint|direct|backsolve (auto: direct while the "
                        "trajectory fits 1/8 of device memory, else checkpoint)")
    p.add_argument("--solver_unroll", type=int, default=0,
                   help="accepted for flag parity (0 = auto)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init_seed", type=int, default=None,
                   help="model-init seed, decoupled from --seed. Default: --seed.")
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--ensemble", type=int, default=0,
                   help="train K repeats of this experiment in one run; member j "
                        "uses init seed --init_seed+j and writes the CSV row of "
                        "trial --trial+j, as K sequential workers would")
    p.add_argument("--rk_baseline", action="store_true", help="also run the RK mean-field baseline")
    p.add_argument("--save_checkpoint", action="store_true", help="save best params")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="periodic checkpoint interval (epochs)")
    p.add_argument("--resume", action="store_true",
                   help="resume a crashed run from its periodic checkpoint")
    p.add_argument("--auto_checkpoint", type=int, default=600,
                   help="save periodic checkpoints (every ~5 minutes) once the "
                        "measured epoch time projects the run past this many "
                        "seconds; 0 disables")
    p.add_argument("--die_at_epoch", type=int, default=None,
                   help="fault injection for crash drills: exit (code 17) at this "
                        "epoch; a --resume run is the recovery and does not die")
    p.add_argument("--log_every", type=int, default=1)
    p.add_argument("--instances_per_graph", type=int, nargs="+", default=None,
                   help="trials per graph; last graph is the unseen eval graph")
    p.add_argument("--node_split", action="store_true",
                   help="train on a node split of the FIRST trial")
    p.add_argument("--spmm", default="auto",
                   choices=["auto", "dense", "dense-bf16", "coo", "ell",
                            "pallas2", "pallas2-bf16"],
                   help="message-passing backend for GN-ODE (auto: dense up "
                        "to 8192 nodes, the CUDA SpMM kernel above; pallas2 "
                        "names that kernel, pallas2-bf16 with bf16 messages)")
    p.add_argument("--gnode_dtype", default="f32", choices=["f32", "bf16"],
                   help="GN-ODE state/matmul compute dtype")
    p.add_argument("--sim_matmul", default="auto", choices=["auto", "bf16", "int8"],
                   help="MC neighbor-count matmul: int8 (int32 sums) or bf16 "
                        "(f32 sums), both exact; auto picks the one measured "
                        "faster on the card, and float32 on the CPU")
    p.add_argument("--coins", default="auto",
                   choices=["auto", "bits16", "rbg16", "bits32", "uniform", "pallas"],
                   help="MC simulator coin generation mode: auto, bits16, rbg16 "
                        "and pallas all name the one fused path (one Philox "
                        "word per node, 16 + 16 bits: the CUDA kernel on a "
                        "card, its plain version on the CPU); bits32 and "
                        "uniform are plain torch ops")
    p.add_argument("--sims_chunk", type=int, default=None,
                   help="MC simulator chunk size")
    p.add_argument("--config", default=None,
                   help="JSON ExperimentConfig file; its fields become flag defaults")
    p.add_argument("--mg_adj", default="auto", choices=["auto", "coo", "dense", "pallas2"],
                   help="multi-graph adjacency backend")
    p.add_argument("--mg_precision", default="f32", choices=["f32", "bf16"],
                   help="multi-graph SpMM message precision")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs; cuda raises when no card is visible")
    return p


def build_model(args, n_nodes, *, batch_size=None, device=None):
    """The one model-construction switch for every trainable family, used by
    the single-graph path, the multigraph path (``n_nodes`` = the padded
    batch width) and serving. ``device`` sizes the GN-ODE solver memory
    policy (default: ``args.device``); the policy's unroll factor has no
    counterpart in the port's Python-loop solver."""
    from gn_ode_sir_tpu_torch.models import GCN, GIN, GNODE, TimeUnrolledSIR
    from gn_ode_sir_tpu_torch.models.gnode import solver_policy

    if args.model == "ode_nn":
        adjoint, _ = solver_policy(
            n_nodes, args.hidden,
            args.batch_size if batch_size is None else batch_size,
            args.maxTime, args.deltaT,
            adjoint=args.adjoint, unroll=args.solver_unroll,
            device=args.device if device is None else device,
        )
        return GNODE(
            hidden=args.hidden,
            max_time=args.maxTime,
            delta_t=args.deltaT,
            method=args.method,
            adjoint=adjoint,
            compute_dtype=args.gnode_dtype,
        )
    if args.model not in ("GCN", "GIN"):
        raise ValueError(f"--model {args.model} is not a trainable model family")
    gnn = GCN if args.model == "GCN" else GIN
    return TimeUnrolledSIR(
        gnn(input_dim=5, hidden_dim=args.hidden,
            penultimate_dim=max(args.hidden // 2, 1), window=args.maxTime))


def build_model_and_adj(args, g, *, batch_size=None, device=None):
    """Model + single-graph adjacency on ``device`` (default ``args.device``),
    exactly as the worker builds them; shared with ``cli.infer``.

    GN-ODE takes ``--spmm``. GCN takes the normalized D^-1/2 (A+I) D^-1/2 as
    a dense matrix up to ``DENSE_NODE_THRESHOLD`` nodes and above it K1 with
    the normalized weights (where the JAX package takes its COO segment sum:
    the port takes for GCN what its ``auto`` takes for GN-ODE there). GIN
    takes the raw-sum ``auto`` adjacency."""
    device = resolve_device(args.device) if device is None else torch.device(device)
    model = build_model(args, g.n_nodes, batch_size=batch_size, device=device)
    return model, _adjacency(args, g, device)


def _adjacency(args, g, device):
    """The single-graph adjacency of ``args.model`` (see
    :func:`build_model_and_adj`); the node-split run takes the same."""
    from gn_ode_sir_tpu_torch.ops import DENSE_NODE_THRESHOLD, gcn_norm_edges
    from gn_ode_sir_tpu_torch.ops.adjacency import DenseAdj, adjacency_from_graph
    from gn_ode_sir_tpu_torch.ops.spmm2 import Spmm2Adj

    if args.model == "ode_nn":
        return adjacency_from_graph(g, kind=args.spmm, device=device)
    if args.model == "GCN":
        src, dst, w = gcn_norm_edges(g)
        if g.n_nodes <= DENSE_NODE_THRESHOLD:
            a = np.zeros((g.n_nodes, g.n_nodes), np.float32)
            a[dst, src] = w
            return DenseAdj(torch.as_tensor(a, device=device))
        return Spmm2Adj.from_edges(src, dst, g.n_nodes, w, device=device)
    return adjacency_from_graph(g, kind="auto", device=device)  # GIN


def checkpoint_dir_for(path_to_save: str, trial, model: str, dataset: str,
                       ensemble: int = 0) -> str:
    """The checkpoint directory a worker run with these arguments uses
    (``--save_checkpoint`` writes ``serve.pt`` there). A ``+``-joined
    dataset's directory carries the graph names: such runs share
    ``path_to_save``. Ensemble runs (K-stacked params) get their own."""
    stem = os.path.basename(dataset)
    ens = f"-ens{ensemble}" if ensemble and ensemble > 1 else ""
    if "+" in stem:
        names = "-".join(stem.split("+"))
        return os.path.join(
            path_to_save, f"ckpt-trial{trial}-{model}{ens}-mg-{names}")
    return os.path.join(path_to_save, f"ckpt-trial{trial}-{model}{ens}")


def load_experiment(args, graph=None):
    """Graph + per-trial labels + TrialData; labels are simulated on
    ``args.device`` on cache miss. ``graph``: an already-built
    :class:`Graph` to use instead of loading ``args.dataset`` (loading needs
    networkx)."""
    from gn_ode_sir_tpu_torch.train import build_trial_data
    from gn_ode_sir_tpu_torch.utils import load_or_extract_labels_many

    if graph is None:
        from gn_ode_sir_tpu_torch.graphs import load_graph

        graph = load_graph(args.dataset)
    g = graph
    i_indices = parse_i_indices(args.I_indices)
    if not (len(args.beta) == len(args.gamma) == len(i_indices)):
        raise SystemExit(
            f"--I_indices/--beta/--gamma must align one value per trial: got "
            f"{len(i_indices)} seed sets, {len(args.beta)} beta, "
            f"{len(args.gamma)} gamma"
        )
    os.makedirs(args.path_to_save, exist_ok=True)

    # persist trial parameters exactly like the reference
    seed_pkl = os.path.join(args.path_to_save, "initial-seed.pkl")
    if not os.path.exists(seed_pkl):
        with open(seed_pkl, "wb") as f:
            pickle.dump(i_indices, f)
        with open(os.path.join(args.path_to_save, "initial-beta.pkl"), "wb") as f:
            pickle.dump(list(args.beta), f)
        with open(os.path.join(args.path_to_save, "initial-gamma.pkl"), "wb") as f:
            pickle.dump(list(args.gamma), f)

    # cache misses are simulated BATCHED (several trials per dispatch);
    # trial k draws from the integer seed 1000 + k
    triples = load_or_extract_labels_many(
        g,
        [(nodes, args.beta[k], args.gamma[k]) for k, nodes in enumerate(i_indices)],
        sim=args.sim,
        max_time=args.maxTime,
        save_dir=args.path_to_save,
        seeds=[1000 + k for k in range(len(i_indices))],
        sims_chunk=args.sims_chunk,
        coins=args.coins,
        matmul=args.sim_matmul,
        device=resolve_device(args.device),
    )
    data = build_trial_data(g.n_nodes, i_indices, args.beta, args.gamma, triples)
    return g, i_indices, data


def get_splits(args, n_trials: int):
    from gn_ode_sir_tpu_torch.train import (
        make_out_of_dist_split,
        out_of_dist_split,
        split_indices,
    )

    if not args.out_of_dist:
        return split_indices(n_trials, tuple(args.train_val_test_ratio))
    ood_path = os.path.join(args.path_to_save, "out-of-dist-gamma.pkl")
    if not os.path.exists(ood_path):
        # the reference ships this dict precomputed; generate it with the
        # same gamma-binned semantics when absent (train/data.py)
        r = args.train_val_test_ratio
        d = make_out_of_dist_split(
            list(args.gamma),
            n_train=int(r[0] * n_trials) if r[0] < 0.5 else int(0.4 * n_trials),
            n_val=int(r[1] * n_trials),
            seed=args.seed,
        )
        with open(ood_path, "wb") as f:
            pickle.dump(d, f)
        print(f"generated gamma-binned out-of-dist split -> {ood_path}")
    d = out_of_dist_split(ood_path)
    test = np.asarray(
        [i for i in range(n_trials) if i not in d["in_train"] and i not in d["in_val"]],
        np.int64,
    )
    return d["train"], d["val"], test


class _FaultInjection:
    """The crash drill of ``--die_at_epoch``: exits the worker (code 17) once
    training reaches the epoch, after that epoch's metrics are logged and
    before its checkpoint, so that ``--resume`` must recover the state from
    the last periodic checkpoint. It rides the ``metrics_logger`` seam, so
    the training loop has no drill-specific hook."""

    def __init__(self, epoch: int):
        self.epoch = epoch

    def log(self, epoch, **kw):
        if epoch >= self.epoch:
            print(f"[fault-injection] dying at epoch {epoch}", flush=True)
            raise SystemExit(17)


def _fit_kwargs(args) -> dict:
    """What ``fit`` and ``fit_ensemble`` take from the flags besides the data:
    the epochs and batches, the crash drill, and the checkpoint directory
    (armed by ``--checkpoint_every``, ``--resume`` or ``--auto_checkpoint``)."""
    armed = args.checkpoint_every or args.resume or args.auto_checkpoint
    return dict(
        epochs=args.epochs, batch_size=args.batch_size, eval_batch_size=args.eval_batch_size,
        verbose=True, log_every=args.log_every,
        # the drill kills the first attempt; the --resume attempt that
        # recovers it (a monitorer retry keeps the job's flags) runs through
        metrics_logger=(None if args.die_at_epoch is None or args.resume
                        else _FaultInjection(args.die_at_epoch)),
        checkpoint_dir=(checkpoint_dir_for(args.path_to_save, args.trial, args.model,
                                           args.dataset, ensemble=args.ensemble)
                        if armed else None),
        checkpoint_every=args.checkpoint_every, checkpoint_auto_s=float(args.auto_checkpoint),
        resume=args.resume)


def _fit_or_ensemble(args, model, data, splits, conn_kwargs, *, device, **kw):
    """``fit`` from ``--init_seed``, or with ``--ensemble K`` the K-repeat
    ``fit_ensemble`` whose member j is seeded as the sequential run with
    ``--init_seed`` + j."""
    from gn_ode_sir_tpu_torch.train import fit, fit_ensemble, init_ensemble

    opt = lambda leaves: torch.optim.Adam(leaves, lr=args.lr)
    if args.ensemble > 1:
        seeds = [args.init_seed + j for j in range(args.ensemble)]
        res = fit_ensemble(model, opt, init_ensemble(model, seeds, device=device), data,
                           *splits, **conn_kwargs, seeds=seeds, **_fit_kwargs(args), **kw)
        print(f"ensemble routes (training, evaluation): {res.routes}")
        return res
    params = model.init(torch.Generator().manual_seed(args.init_seed), device=device)
    return fit(model, opt, params, data, *splits, **conn_kwargs, seed=args.init_seed,
               **_fit_kwargs(args), **kw)


def _save_result_rows(cfg, dataset_name, res, args, loss_baseline=0.0, rk_time=0.0):
    """Write the run's CSV row(s): one for a ``fit`` result, K for an
    ensemble (trial ``--trial`` + j for member j), the rows K sequential
    workers with init seeds ``--init_seed`` + j would write.
    ``loss_baseline`` and ``rk_time`` come from the RK mean-field baseline
    (``--rk_baseline``), else 0."""
    from gn_ode_sir_tpu_torch.utils.csvsink import save_trial_to_csv

    if args.ensemble > 1:
        for j in range(args.ensemble):
            save_trial_to_csv(dataclasses.replace(cfg, trial=args.trial + j), dataset_name,
                              int(res.best_epoch[j]), float(res.best_val_loss[j]),
                              float(res.test_loss[j]), loss_baseline, res.test_time, rk_time)
    else:
        save_trial_to_csv(cfg, dataset_name, res.best_epoch, res.best_val_loss,
                          res.test_loss, loss_baseline, res.test_time, rk_time)


def _print_test_loss(args, res, suffix=""):
    if args.ensemble > 1:
        for j in range(args.ensemble):
            print(f"Test Loss{suffix}: {float(res.test_loss[j]):.5f} at epoch: "
                  f"{int(res.best_epoch[j]):03d} (trial {args.trial + j})")
    else:
        print(f"Test Loss{suffix}: {res.test_loss:.5f} at epoch: {res.best_epoch:03d}")


def run_trainable(args, g, data, splits):
    device = resolve_device(args.device)
    model, adj = build_model_and_adj(args, g, device=device)
    # out-of-dist runs need the per-trial test-loss vector for the first OOD CSV
    res = _fit_or_ensemble(args, model, data, splits, {"adj_fn": lambda gi: adj},
                           device=device, track_test_per_trial=args.out_of_dist)
    if args.save_checkpoint:
        _save_serve_checkpoint(args, res)
    return res


def _save_serve_checkpoint(args, res):
    """Best-val-epoch params as ``<ckpt dir>/serve.pt`` — the weights the
    reported test_loss was scored with (``FitResult.best_params``; the
    final-epoch params would be a different, possibly overfit model). An
    ensemble's K-stacked params go to its ``-ensK`` directory, which a
    sequential run of the same trial does not read."""
    from gn_ode_sir_tpu_torch.train.checkpoint import save_params

    best = res.best_params if res.best_params is not None else res.params
    save_params(checkpoint_dir_for(args.path_to_save, args.trial, args.model, args.dataset,
                                   ensemble=args.ensemble), best)


def _test_seed_sets(data, te, n_nodes):
    return [np.nonzero(data.i0[i][:n_nodes])[0] for i in te]


def run_dmp(args, g, data, splits):
    """Closed-form DMP inference on the test split, all its trials in one
    batched recursion on ``args.device``."""
    from gn_ode_sir_tpu_torch.models import DMPSIR

    _, _, te = splits
    dmp = DMPSIR.from_graph(g)
    t0 = time.time()
    m = dmp.run_many(
        _test_seed_sets(data, te, g.n_nodes),
        [float(data.beta[i]) for i in te], [float(data.gamma[i]) for i in te],
        max_time=args.maxTime, device=resolve_device(args.device),
    ).cpu().numpy()  # [B, T, n, 3]
    losses = [np.abs(m[k, 1:] - data.labels[i][1:]).mean() for k, i in enumerate(te)]
    dt = time.time() - t0
    test_loss = float(np.mean(losses))
    print(f"DMP baseline Loss: {test_loss:.5f}")
    print(f"Time inference baseline: {dt:.5f}")
    return test_loss, dt


def run_rk(args, g, data, te, label=""):
    """Classical mean-field baseline on the trials ``te`` of graph ``g``
    (whose labels may be padded beyond its nodes), integrated together."""
    from gn_ode_sir_tpu_torch.sim import sir_classical_batch

    t0 = time.time()
    i_b, s_b, r_b = sir_classical_batch(
        g, _test_seed_sets(data, te, g.n_nodes),
        [float(data.beta[i]) for i in te], [float(data.gamma[i]) for i in te],
        delta_t=args.deltaT, max_time=args.maxTime, device=resolve_device(args.device),
    )
    preds = np.stack([s_b, i_b, r_b], -1)  # [B, T, n, 3]
    losses = [np.abs(preds[k] - data.labels[i][:, : g.n_nodes]).mean()
              for k, i in enumerate(te)]
    dt = time.time() - t0
    loss = float(np.mean(losses))
    print(f"Runge-kutta baseline Loss{label}: {loss:.5f}")
    print(f"Time inference baseline: {dt:.5f}")
    return loss, dt


def _trial_pickles(label_dir):
    return [os.path.join(label_dir, f"initial-{k}.pkl") for k in ("seed", "beta", "gamma")]


def run_multigraph(args, graphs=None):
    """'+'-joined datasets: train on G-1 graphs, evaluate on the unseen last
    graph. ``graphs``: already-built :class:`Graph` objects that stand for
    ``--dataset`` (loading needs networkx)."""
    from gn_ode_sir_tpu_torch.train import (
        assemble_multigraph_trials,
        multigraph_auto_fns,
        multigraph_split,
    )
    from gn_ode_sir_tpu_torch.utils.config import ExperimentConfig

    if args.model not in ("ode_nn", "GCN", "GIN"):
        raise SystemExit(
            f"--model {args.model} is single-graph only; multi-graph datasets "
            "support ode_nn/GCN/GIN (the dmp/rk baselines are single-graph)"
        )
    if args.out_of_dist:
        # refuse rather than silently train the ordinary protocol: the
        # gamma-binned split is a single-graph protocol
        raise SystemExit(
            "--out_of_dist is a single-graph protocol; it is not defined for "
            "'+'-joined multi-graph datasets"
        )

    if graphs is None:
        from gn_ode_sir_tpu_torch.graphs import load_graphs

        graphs = load_graphs(args.dataset)
    device = resolve_device(args.device)
    names = [g.name for g in graphs]
    counts = args.instances_per_graph or ([36] * (len(graphs) - 1) + [120])
    if len(counts) != len(graphs):
        raise SystemExit("--instances_per_graph must give one count per graph")

    # trial parameters: provided flat via the reference argv encoding, or sampled
    i_indices = parse_i_indices(args.I_indices) if args.I_indices != ["12"] else None
    if i_indices is not None and not (
        len(args.beta) == len(args.gamma) == len(i_indices)
    ):
        raise SystemExit(
            f"--I_indices/--beta/--gamma must align one value per trial: got "
            f"{len(i_indices)} seed sets, {len(args.beta)} beta, "
            f"{len(args.gamma)} gamma"
        )
    if i_indices is not None and len(i_indices) != sum(counts):
        raise SystemExit(
            f"--I_indices gives {len(i_indices)} trials but "
            f"--instances_per_graph sums to {sum(counts)}"
        )
    # per-graph label dirs, reference layout
    label_dirs = []
    for name in names:
        d = os.path.join(args.path_to_save, f"Experiments-seed2-{name}")
        os.makedirs(d, exist_ok=True)
        label_dirs.append(d)

    # Per-graph trial params are persisted in the reference's
    # initial-{seed,beta,gamma}.pkl layout and reloaded on rerun, so repeat
    # runs train and evaluate on identical trial sets and reuse the label
    # cache — only the model init varies (--init_seed). Sampling is seeded
    # per (seed, graph), so a missing graph's params regenerate
    # independently of the others.
    per_graph_params = []
    pos = 0
    for g_i, g in enumerate(graphs):
        pickles = _trial_pickles(label_dirs[g_i])
        if i_indices is not None:
            trials = [
                (i_indices[p], args.beta[p], args.gamma[p])
                for p in range(pos, pos + counts[g_i])
            ]
            pos += counts[g_i]
        elif os.path.exists(pickles[0]):
            ii, bb, gg = [], [], []
            for path, into in zip(pickles, (ii, bb, gg)):
                with open(path, "rb") as f:
                    into.extend(pickle.load(f))
            if len(ii) < counts[g_i]:
                raise SystemExit(
                    f"{pickles[0]} pins {len(ii)} trials < requested {counts[g_i]}"
                )
            trials = [(list(ii[k]), float(bb[k]), float(gg[k]))
                      for k in range(counts[g_i])]
        else:
            rng = np.random.default_rng([args.seed, g_i])
            trials = [(
                [int(x) for x in rng.choice(g.n_nodes, 2, replace=False)],
                float(rng.uniform(0.1, 0.5)),
                float(rng.uniform(0.1, 0.5)),
            ) for _ in range(counts[g_i])]
            for k, path in enumerate(pickles):
                with open(path, "wb") as f:
                    pickle.dump([t[k] for t in trials], f)
        per_graph_params.append(trials)

    batch, data = assemble_multigraph_trials(
        graphs, per_graph_params, label_dirs=label_dirs,
        sim=args.sim, max_time=args.maxTime, seed=args.seed, device=device,
    )
    print(f"graphs: {names}, padded to n={batch.n_max}, e={batch.e_max}")
    tr, va, te = multigraph_split(counts)

    # shared switch with the single-graph worker and serving restore
    # (n_nodes = the padded batch width drives the solver memory policy)
    model = build_model(args, batch.n_max, device=device)
    # backend dispatch by scale: dense / coo / K1 with grouped batches above
    # the dense limit — the same path library users get
    conn = multigraph_auto_fns(
        batch, gcn_normalized=args.model == "GCN", eval_graph=-1, kind=args.mg_adj,
        precision=args.mg_precision, device=device)
    print(f"multigraph adjacency backend: {conn.kind}")

    res = _fit_or_ensemble(args, model, data, (tr, va, te), conn.fit_kwargs(), device=device)

    # RK mean-field baseline on the UNSEEN graph's test trials
    loss_baseline, rk_time = 0.0, 0.0
    if args.rk_baseline:
        loss_baseline, rk_time = run_rk(args, graphs[-1], data, te,
                                        label=f" (unseen {names[-1]})")
    cfg = ExperimentConfig(
        model=args.model, hidden=args.hidden, lr=args.lr, epochs=args.epochs,
        batch_size=args.batch_size, beta=list(args.beta), gamma=list(args.gamma),
        i_indices=i_indices or [], delta_t=args.deltaT, max_time=args.maxTime,
        sim=args.sim, dataset=args.dataset, path_to_save=args.path_to_save,
        train_val_test_ratio=list(args.train_val_test_ratio), trial=args.trial,
    )
    _save_result_rows(cfg, "+".join(names), res, args, loss_baseline, rk_time)
    _print_test_loss(args, res, suffix=f" (unseen graph {names[-1]})")
    if args.save_checkpoint:
        # the params are graph-agnostic, so this checkpoint serves ANY graph
        # through cli/infer.py
        _save_serve_checkpoint(args, res)
    return 0


def run_node_split(args, graph=None):
    """The legacy transductive protocol: one trial, the graph's nodes split
    60/20/20, the C6 GN-ODE (relu, rk4, layer-normed derivative) or the
    3-feature GCN/GIN, and the RK mean-field baseline at the end (on every
    node and on the test nodes; the test MAE fills ``loss_baseline``)."""
    from gn_ode_sir_tpu_torch.models import GCN, GIN, TimeUnrolledSIR
    from gn_ode_sir_tpu_torch.models.gnode import legacy_dense_gnode
    from gn_ode_sir_tpu_torch.sim import sir_classical
    from gn_ode_sir_tpu_torch.train import fit_node_split, node_split_indices
    from gn_ode_sir_tpu_torch.utils.config import ExperimentConfig
    from gn_ode_sir_tpu_torch.utils.csvsink import save_trial_to_csv

    # the legacy CLI convention: a flat int list is ONE seed set
    # ("--I_indices 25 18" == seeds {25, 18}), unlike the per-trial
    # list-strings of the batched protocol
    if len(args.I_indices) > 1 and all("[" not in str(s) and "," not in str(s)
                                       for s in args.I_indices):
        args.I_indices = ["[" + ", ".join(str(s) for s in args.I_indices) + "]"]
    device = resolve_device(args.device)
    g, i_indices, data = load_experiment(args, graph)
    print(f"nodes {g.n_nodes}\nedges {g.n_edges // 2}")
    seeds, beta, gamma = i_indices[0], args.beta[0], args.gamma[0]
    labels = data.labels[0]  # [T, n, 3]
    idx_train, idx_val, idx_test = node_split_indices(g.n_nodes,
                                                      tuple(args.train_val_test_ratio))
    if args.model == "ode_nn":
        model = legacy_dense_gnode(hidden=args.hidden, max_time=args.maxTime,
                                   delta_t=args.deltaT)
    else:  # the legacy 3-feature GCN / GIN
        gnn = GCN if args.model == "GCN" else GIN
        model = TimeUnrolledSIR(gnn(input_dim=3, hidden_dim=args.hidden,
                                    penultimate_dim=max(args.hidden // 2, 1),
                                    window=args.maxTime), with_rates=False)
    adj = _adjacency(args, g, device)
    params = model.init(torch.Generator().manual_seed(args.init_seed), device=device)
    res = fit_node_split(
        model, lambda leaves: torch.optim.Adam(leaves, lr=args.lr), params, adj,
        data.s0[0], data.i0[0], data.r0[0], beta, gamma, labels,
        idx_train=idx_train, idx_val=idx_val, idx_test=idx_test,
        epochs=args.epochs, verbose=True, log_every=args.log_every)
    print(f"Test Loss: {res.test_loss:.5f} at epoch: {res.best_epoch:03d}")

    t0 = time.time()
    i_t, s_t, r_t = sir_classical(g, seeds, beta, gamma, delta_t=args.deltaT,
                                  max_time=args.maxTime, device=device)
    pred = np.stack([s_t, i_t, r_t], -1)
    loss_baseline_full = float(np.abs(pred - labels).mean())
    rk_time = time.time() - t0
    loss_baseline = float(np.abs(pred[:, idx_test] - labels[:, idx_test]).mean())
    print(f"Runge-kutta baseline Loss: {loss_baseline_full:.5f}")
    print(f"Runge-kutta baseline test Loss: {loss_baseline:.5f}")

    cfg = ExperimentConfig(
        model=args.model, hidden=args.hidden, lr=args.lr, epochs=args.epochs,
        batch_size=args.batch_size, beta=list(args.beta), gamma=list(args.gamma),
        i_indices=i_indices, delta_t=args.deltaT, max_time=args.maxTime,
        sim=args.sim, dataset=args.dataset, path_to_save=args.path_to_save,
        train_val_test_ratio=list(args.train_val_test_ratio), trial=args.trial,
    )
    save_trial_to_csv(cfg, g.name, res.best_epoch, res.best_val_loss, res.test_loss,
                      loss_baseline, res.test_time, rk_time)
    return 0


# ExperimentConfig field -> CLI flag name (reference argv naming kept)
_CONFIG_TO_FLAG = {
    "model": "model", "hidden": "hidden", "lr": "lr", "epochs": "epochs",
    "batch_size": "batch_size", "beta": "beta", "gamma": "gamma",
    "delta_t": "deltaT", "max_time": "maxTime", "sim": "sim",
    "dataset": "dataset", "path_to_save": "path_to_save",
    "train_val_test_ratio": "train_val_test_ratio", "trial": "trial",
    "method": "method", "adjoint": "adjoint", "seed": "seed",
    "init_seed": "init_seed",
    "out_of_dist": "out_of_dist", "i_indices": "I_indices",
    "spmm": "spmm", "coins": "coins", "sim_matmul": "sim_matmul",
    "gnode_dtype": "gnode_dtype", "solver_unroll": "solver_unroll",
    "mg_adj": "mg_adj",
    "sims_chunk": "sims_chunk", "instances_per_graph": "instances_per_graph",
    "node_split": "node_split", "eval_batch_size": "eval_batch_size",
}


def _apply_config_defaults(parser, argv):
    """Pre-scan for --config and install its fields as parser defaults
    (explicit CLI flags still override)."""
    import json

    argv = list(argv) if argv is not None else None
    probe, _ = parser.parse_known_args(argv)
    if not probe.config:
        return argv
    with open(probe.config) as f:
        cfg = json.load(f)
    defaults = {}
    for field, flag in _CONFIG_TO_FLAG.items():
        if field in cfg and cfg[field] not in (None, [], ()):
            v = cfg[field]
            if field == "i_indices":
                v = [str(list(s)) for s in v]
            defaults[flag] = v
    parser.set_defaults(**defaults)
    return argv


def _check_modes(args) -> None:
    """The JAX worker's refusals of mode combinations."""
    if args.ensemble > 1:
        if args.node_split:
            raise SystemExit(
                "--ensemble covers the batched trainable protocols only (the "
                "transductive node-split engine runs sequentially — drop --ensemble)")
        if args.model in ("dmp", "rk"):
            raise SystemExit(
                f"--ensemble is meaningless for --model {args.model}: the closed-form "
                "baselines have no trained init to repeat")


def main(argv=None, graph=None):
    """Run one experiment. ``graph``: an already-built :class:`Graph` that
    stands for ``--dataset`` (for callers on a machine without networkx), or
    the list of them for a ``+``-joined dataset."""
    from gn_ode_sir_tpu_torch.cli import apply_data_root_default
    from gn_ode_sir_tpu_torch.utils.config import ExperimentConfig
    from gn_ode_sir_tpu_torch.utils.csvsink import csv_trials, save_trial_to_csv

    apply_data_root_default()
    parser = build_parser()
    argv = _apply_config_defaults(parser, argv)
    args = parser.parse_args(argv)
    if args.init_seed is None:
        args.init_seed = args.seed
    _check_modes(args)
    resolve_device(args.device)
    # full-f32 matmuls: TF32 would quietly change every dense A·Z and linear
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if "+" in os.path.basename(args.dataset):
        return run_multigraph(args, graph)
    if args.node_split:
        return run_node_split(args, graph)

    g, i_indices, data = load_experiment(args, graph)
    print(f"nodes {g.n_nodes}\nedges {g.n_edges // 2}")
    splits = get_splits(args, data.num_trials)

    cfg = ExperimentConfig(
        model=args.model, hidden=args.hidden, lr=args.lr, epochs=args.epochs,
        batch_size=args.batch_size, beta=list(args.beta), gamma=list(args.gamma),
        i_indices=i_indices, delta_t=args.deltaT, max_time=args.maxTime,
        sim=args.sim, dataset=args.dataset, path_to_save=args.path_to_save,
        train_val_test_ratio=list(args.train_val_test_ratio),
        out_of_dist=args.out_of_dist, trial=args.trial,
    )
    dataset_name = g.name

    if args.model == "dmp":
        test_loss, dt = run_dmp(args, g, data, splits)
        save_trial_to_csv(cfg, dataset_name, 0, 0.0, test_loss, 0.0, dt, 0.0)
        return 0
    if args.model == "rk":
        loss, dt = run_rk(args, g, data, splits[2])
        save_trial_to_csv(cfg, dataset_name, 0, 0.0, loss, loss, dt, dt)
        return 0

    res = run_trainable(args, g, data, splits)
    loss_baseline, rk_time = 0.0, 0.0
    if args.rk_baseline:
        loss_baseline, rk_time = run_rk(args, g, data, splits[2])

    if not args.out_of_dist:
        _save_result_rows(cfg, dataset_name, res, args, loss_baseline, rk_time)
    else:
        # out-of-dist runs write the two extra CSVs, an ensemble one row per
        # member (trial --trial + j), as K sequential workers would
        k = args.ensemble if args.ensemble > 1 else 0
        per_trial_rows = [res.test_loss_all[j] for j in range(k)] if k else [res.test_loss_all]
        summary_rows = ([(args.trial + j, int(res.best_epoch[j]), float(res.best_val_loss[j]),
                          float(res.test_loss[j])) for j in range(k)] if k else
                        [(args.trial, res.best_epoch, res.best_val_loss, res.test_loss)])
        for losses in per_trial_rows:
            # (1) per-test-trial losses, header = test trial indices
            csv_trials(
                os.path.join(args.path_to_save, f"Out-of-dist-gamma-{dataset_name}"),
                [str(int(i)) for i in splits[2]],
                [float(x) for x in losses],
            )
        for trial, best_epoch, val_loss, test_loss in summary_rows:
            # (2) the per-run summary row
            csv_trials(
                os.path.join(args.path_to_save, f"Out-of-dist-gamma-trials-{dataset_name}"),
                ["trial", "model", "lr", "epochs", "deltaT", "maxTime", "hidden",
                 "best_epoch", "val_loss", "test_loss", "n_ode_time"],
                [trial, args.model, args.lr, args.epochs, args.deltaT, args.maxTime,
                 args.hidden, best_epoch, val_loss, test_loss, res.test_time],
            )
    _print_test_loss(args, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
