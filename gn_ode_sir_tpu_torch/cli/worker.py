"""Experiment worker (port of ``gn_ode_sir_tpu.cli.worker``): so far the parts
serving needs — the argument parser, with the same flags and defaults as the
JAX worker plus ``--device``, and the model/adjacency construction that
``cli.infer`` scores a checkpoint through. Training (``main``) is not ported
yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import argparse

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
    p.add_argument("--auto_checkpoint", type=int, default=600,
                   help="auto-enable periodic checkpoints once the run projects "
                        "past this many seconds; 0 disables")
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
                   help="MC neighbor-count matmul dtype")
    p.add_argument("--coins", default="auto",
                   choices=["auto", "bits16", "rbg16", "bits32", "uniform", "pallas"],
                   help="MC simulator coin generation mode")
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
