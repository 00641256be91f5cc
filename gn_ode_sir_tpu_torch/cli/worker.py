"""Experiment worker — the CLI entry point for one experiment run (port of
``gn_ode_sir_tpu.cli.worker``), with the same flags and defaults as the JAX
worker plus ``--device``:

  python -m gn_ode_sir_tpu_torch.cli.worker --dataset ./real_graphs/karate \\
      --model ode_nn --hidden 64 --epochs 500 --lr 1e-4 --batch_size 1 \\
      --I_indices "[25, 18]" "[1, 27]" --beta 0.47 0.26 --gamma 0.31 0.33 \\
      --path_to_save ./experiments/karate

Ported: ``--model ode_nn`` on a single graph, with and without
``--out_of_dist`` — Monte-Carlo labels on cache miss, training, the
reference-schema CSV row, and ``--save_checkpoint`` (a ``serve.pt`` that
``cli.infer --ckpt`` scores). The model and adjacency construction is shared
with ``cli.infer``. Everything else the JAX worker does raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch


AUTO_CHECKPOINT_DEFAULT = 600  # seconds, the JAX worker's default


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
    p.add_argument("--method", default="euler", help="ODE solver (euler/midpoint/rk4/dopri5)")
    p.add_argument("--adjoint", default="auto",
                   help="auto|checkpoint|direct (auto: direct while the "
                        "trajectory fits 1/8 of device memory, else checkpoint)")
    p.add_argument("--solver_unroll", type=int, default=0,
                   help="accepted for flag parity (0 = auto)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init_seed", type=int, default=None,
                   help="model-init seed, decoupled from --seed. Default: --seed.")
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--ensemble", type=int, default=0,
                   help="train K repeats of this experiment as one program")
    p.add_argument("--rk_baseline", action="store_true", help="also run the RK mean-field baseline")
    p.add_argument("--save_checkpoint", action="store_true", help="save best params")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="periodic checkpoint interval (epochs)")
    p.add_argument("--resume", action="store_true",
                   help="resume a crashed run from its periodic checkpoint")
    p.add_argument("--auto_checkpoint", type=int, default=AUTO_CHECKPOINT_DEFAULT,
                   help="seconds between automatic periodic checkpoints; "
                        "not ported yet, any value but the default raises")
    p.add_argument("--die_at_epoch", type=int, default=None,
                   help="fault injection: exit (code 17) at this epoch")
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
    """The model-construction switch (GN-ODE only so far). ``device`` sizes
    the solver memory policy (default: ``args.device``); the policy's unroll
    factor has no counterpart in the port's Python-loop solver."""
    from gn_ode_sir_tpu_torch.models.gnode import GNODE, solver_policy

    if args.model in ("GCN", "GIN"):
        raise NotImplementedError(
            f"--model {args.model} is not ported yet (ROADMAP.md Queue 1: models/gcn.py, gin.py)")
    if args.model != "ode_nn":
        raise ValueError(f"--model {args.model} is not a trainable model family")
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


def build_model_and_adj(args, g, *, batch_size=None, device=None):
    """Model + single-graph adjacency on ``device`` (default ``args.device``),
    exactly as the worker builds them; shared with ``cli.infer``."""
    from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph

    device = resolve_device(args.device) if device is None else torch.device(device)
    model = build_model(args, g.n_nodes, batch_size=batch_size, device=device)
    adj = adjacency_from_graph(g, kind=args.spmm, device=device)
    return model, adj


def checkpoint_dir_for(path_to_save: str, trial, model: str) -> str:
    """The checkpoint directory a worker run with these arguments uses
    (``--save_checkpoint`` writes ``serve.pt`` there)."""
    return os.path.join(path_to_save, f"ckpt-trial{trial}-{model}")


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


def _save_result_rows(cfg, dataset_name, res):
    """Write the run's CSV row. ``loss_baseline`` and ``rk_time`` are 0: the
    RK mean-field baseline that fills them is not ported yet."""
    from gn_ode_sir_tpu_torch.utils.csvsink import save_trial_to_csv

    save_trial_to_csv(cfg, dataset_name, res.best_epoch, res.best_val_loss,
                      res.test_loss, 0.0, res.test_time, 0.0)


def run_trainable(args, g, data, splits):
    from gn_ode_sir_tpu_torch.train import fit

    tr, va, te = splits
    device = resolve_device(args.device)
    model, adj = build_model_and_adj(args, g, device=device)
    params = model.init(torch.Generator().manual_seed(args.init_seed), device=device)
    res = fit(
        model,
        lambda leaves: torch.optim.Adam(leaves, lr=args.lr),
        params,
        data,
        tr,
        va,
        te,
        lambda gi: adj,
        seed=args.init_seed,
        epochs=args.epochs,
        batch_size=args.batch_size,
        eval_batch_size=args.eval_batch_size,
        verbose=True,
        log_every=args.log_every,
        # out-of-dist runs need the per-trial test-loss vector for the
        # first OOD CSV
        track_test_per_trial=args.out_of_dist,
    )
    if args.save_checkpoint:
        _save_serve_checkpoint(args, res)
    return res


def _save_serve_checkpoint(args, res):
    """Best-val-epoch params as ``<ckpt dir>/serve.pt`` — the weights the
    reported test_loss was scored with (``FitResult.best_params``; the
    final-epoch params would be a different, possibly overfit model)."""
    from gn_ode_sir_tpu_torch.train.checkpoint import save_params

    best = res.best_params if res.best_params is not None else res.params
    save_params(checkpoint_dir_for(args.path_to_save, args.trial, args.model), best)


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


def _refuse_unported(args) -> None:
    """Everything the JAX worker does beyond single-graph ``--model ode_nn``
    raises here, naming the ROADMAP.md item that ports it."""
    unported = [
        (args.ensemble > 1, "--ensemble", "train/ensemble.py"),
        ("+" in os.path.basename(args.dataset), "'+'-joined multi-graph datasets",
         "train/multigraph.py"),
        (args.node_split, "--node_split", "train/node_split.py"),
        (args.model == "dmp", "--model dmp", "models/dmp.py"),
        (args.model == "rk", "--model rk", "sim/classical.py"),
        (args.rk_baseline, "--rk_baseline", "sim/classical.py"),
        (args.checkpoint_every or args.resume or args.die_at_epoch is not None
         or args.auto_checkpoint != AUTO_CHECKPOINT_DEFAULT,
         "--checkpoint_every/--resume/--auto_checkpoint/--die_at_epoch",
         "train/checkpoint.py + resume in fit"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md Queue 1: {item})")


def main(argv=None, graph=None):
    """Run one experiment. ``graph``: an already-built :class:`Graph` that
    stands for ``--dataset`` (for callers on a machine without networkx)."""
    from gn_ode_sir_tpu_torch.cli import apply_data_root_default
    from gn_ode_sir_tpu_torch.utils.config import ExperimentConfig
    from gn_ode_sir_tpu_torch.utils.csvsink import csv_trials

    apply_data_root_default()
    parser = build_parser()
    argv = _apply_config_defaults(parser, argv)
    args = parser.parse_args(argv)
    if args.init_seed is None:
        args.init_seed = args.seed
    _refuse_unported(args)
    resolve_device(args.device)
    # full-f32 matmuls: TF32 would quietly change every dense A·Z and linear
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    res = run_trainable(args, g, data, splits)

    if not args.out_of_dist:
        _save_result_rows(cfg, dataset_name, res)
    else:
        # out-of-dist runs write the two extra CSVs:
        # (1) per-test-trial losses, header = test trial indices
        csv_trials(
            os.path.join(args.path_to_save, f"Out-of-dist-gamma-{dataset_name}"),
            [str(int(i)) for i in splits[2]],
            [float(x) for x in res.test_loss_all],
        )
        # (2) the per-run summary row
        csv_trials(
            os.path.join(args.path_to_save, f"Out-of-dist-gamma-trials-{dataset_name}"),
            ["trial", "model", "lr", "epochs", "deltaT", "maxTime", "hidden",
             "best_epoch", "val_loss", "test_loss", "n_ode_time"],
            [args.trial, args.model, args.lr, args.epochs, args.deltaT, args.maxTime,
             args.hidden, res.best_epoch, res.best_val_loss, res.test_loss, res.test_time],
        )
    print(f"Test Loss: {res.test_loss:.5f} at epoch: {res.best_epoch:03d}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
