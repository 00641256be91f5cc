"""Monitorer — runs the experiment matrix (port of
``gn_ode_sir_tpu.cli.monitorer``), with the same flags and defaults plus
``--device``:

  python -m gn_ode_sir_tpu_torch.cli.monitorer                  # full matrix, on the card
  python -m gn_ode_sir_tpu_torch.cli.monitorer --device cpu \\
      --datasets ./real_graphs/karate --experiments_root ./exp    # on the CPU
  python -m gn_ode_sir_tpu_torch.cli.monitorer --ngraphs --ensemble  # the multi-graph matrix
  python -m gn_ode_sir_tpu_torch.cli.monitorer --only 3 7       # rerun selected
  python -m gn_ode_sir_tpu_torch.cli.monitorer --retry 1        # resume a crashed job

Experiments run in this process by default (``--subprocess``: each in
``python -m gn_ode_sir_tpu_torch.cli.worker``). As in the reference:

- trial parameters are sampled once and persisted/reloaded via
  ``initial-{seed,beta,gamma}.pkl``;
- ``--only N ...`` reruns selected procedures;
- a failed experiment prints the reference's marker line and the matrix
  goes on;
- ``--retry N`` retries a failed job in a fresh process, with ``--resume``
  only when an earlier attempt of that job wrote its periodic checkpoint;
- ``--ensemble`` folds repeats of one hidden size into one ``--ensemble K``
  worker; ``--per_trial`` fans the trials out as ``--node_split`` workers.

``--device`` (default ``cuda``, which raises without a card) goes to every
worker. The JAX package turns on XLA's persistent compilation cache here;
the port's counterpart is the kernel build directory
(``gn_ode_sir_tpu_torch/_build``), which every worker of the matrix reuses.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np


@dataclasses.dataclass
class MatrixConfig:
    """The monitorer knobs (defaults: the reference's ``monitorer-sim.py``)."""

    many_graph_instances: bool = True
    epochs: int = 500
    lr: float = 1e-4
    batch_size: int = 1
    train_val_test_ratio: tuple = (0.6, 0.2, 0.2)
    n_i: tuple = (2,)
    trials_per_number: int = 200
    delta_t: float = 0.5
    max_time: int = 20
    sim: int = 10000
    hidden_dim_array: tuple = (64,)
    datasets_array: tuple = ("./real_graphs/karate",)
    model: str = "ode_nn"
    out_of_dist: bool = False
    experiments_root: str = "./multi-graph-1"
    seed: int | None = None
    # flags appended to every worker's argv, e.g. ("--instances_per_graph",
    # "8", ...) to cut a '+' dataset's depth, ("--checkpoint_every", "1"),
    # ("--spmm", "pallas2")
    worker_flags: tuple = ()


def random_parameters_sir(graph, n_i, trials_per_number, rng=None):
    """Sample (seed set, beta, gamma) per trial."""
    rng = rng or np.random.default_rng()
    i_indices, betas, gammas = [], [], []
    for k in n_i:
        for _ in range(trials_per_number):
            i_indices.append([int(i) for i in rng.choice(graph.n_nodes, k, replace=False)])
            betas.append(float(rng.uniform(0.1, 0.5)))
            gammas.append(float(rng.uniform(0.1, 0.5)))
    return i_indices, betas, gammas


def _load_or_create_params(cfg: MatrixConfig, dataset: str, path_to_save: str, graph=None):
    """The persisted trial parameters of ``path_to_save``, or new ones sampled
    on ``graph`` (default: ``dataset`` loaded, which needs networkx)."""
    seed_pkl = os.path.join(path_to_save, "initial-seed.pkl")
    if os.path.exists(seed_pkl):
        out = []
        for key in ("seed", "beta", "gamma"):
            with open(os.path.join(path_to_save, f"initial-{key}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return tuple(out)
    if graph is None:
        from gn_ode_sir_tpu_torch.graphs import load_graph

        graph = load_graph(dataset)
    return random_parameters_sir(graph, cfg.n_i, cfg.trials_per_number,
                                 np.random.default_rng(cfg.seed))


def build_worker_argv(cfg: MatrixConfig, dataset, path_to_save, hidden, trial,
                      i_indices, betas, gammas) -> list[str]:
    argv = [
        "--lr", str(cfg.lr), "--epochs", str(cfg.epochs), "--hidden", str(hidden),
        "--batch_size", str(cfg.batch_size),
        "--train_val_test_ratio", *[str(r) for r in cfg.train_val_test_ratio],
        "--deltaT", str(cfg.delta_t), "--maxTime", str(cfg.max_time),
        "--sim", str(cfg.sim), "--trial", str(trial), "--dataset", dataset,
        "--path_to_save", path_to_save, "--model", cfg.model,
        # --seed pins trial sampling and splits across repeats; only the
        # model-init seed varies per repeat (the reference's repeats differ
        # only by torch's unseeded init)
        "--seed", str(cfg.seed or 0),
        "--init_seed", str((cfg.seed or 0) + trial - 1),
    ]
    if i_indices:
        argv += ["--I_indices", *[str(i) for i in i_indices]]
        argv += ["--beta", *[str(b) for b in betas]]
        argv += ["--gamma", *[str(g) for g in gammas]]
    if cfg.out_of_dist:
        argv.append("--out_of_dist")
    return argv + [str(f) for f in cfg.worker_flags]


def _newest_mtime(root: str):
    """Newest file mtime under ``root`` (None when absent or empty): how the
    retry loop tells a checkpoint written by this job's earlier attempt from
    one left behind by an earlier run."""
    newest = None
    if os.path.isdir(root):
        for r, _, files in os.walk(root):
            for f in files:
                try:
                    m = os.path.getmtime(os.path.join(r, f))
                except OSError:
                    continue
                newest = m if newest is None else max(newest, m)
    return newest


def _matrix_jobs(cfg: MatrixConfig, ensemble: bool, graphs):
    """Every job of the matrix, in order:
    (dataset, stem, path_to_save, trial, hidden, ii, bb, gg, extra argv, K)."""
    all_jobs = []
    for dataset in cfg.datasets_array:
        stem = os.path.basename(dataset)
        if "+" in stem:
            # '+'-joined datasets: per-graph label dirs live directly under the
            # experiments root; the worker samples and caches trial params
            path_to_save = cfg.experiments_root
            os.makedirs(path_to_save, exist_ok=True)
            i_indices, betas, gammas = [], [], []
        else:
            path_to_save = os.path.join(cfg.experiments_root,
                                        f"Experiments-seed{cfg.n_i[0]}-{stem}")
            os.makedirs(path_to_save, exist_ok=True)
            i_indices, betas, gammas = _load_or_create_params(
                cfg, dataset, path_to_save, (graphs or {}).get(dataset))
        if cfg.many_graph_instances and ensemble:
            # runs of one hidden size (the repeat protocol) fold into one
            # --ensemble worker writing the same K CSV rows
            jobs, trial = [], 1
            for hidden, grp in itertools.groupby(cfg.hidden_dim_array):
                k = len(list(grp))
                extra = ("--ensemble", str(k)) if k > 1 else ()
                jobs.append((trial, hidden, i_indices, betas, gammas, extra, k))
                trial += k
        elif cfg.many_graph_instances:
            # one experiment per hidden size, all trials batched inside it
            jobs = [(t, hidden, i_indices, betas, gammas, (), 1)
                    for t, hidden in enumerate(cfg.hidden_dim_array, start=1)]
        else:
            # the legacy per-trial fan-out: one node-split worker per (trial,
            # hidden) pair
            pairs = ((k, h) for k in range(len(i_indices)) for h in cfg.hidden_dim_array)
            jobs = [(t, hidden, [i_indices[k]], [betas[k]], [gammas[k]], ("--node_split",), 1)
                    for t, (k, hidden) in enumerate(pairs, start=1)]
        all_jobs += [(dataset, stem, path_to_save) + job for job in jobs]
    return all_jobs


def run_matrix(cfg: MatrixConfig, only=(), use_subprocess: bool = False, retries: int = 0,
               retry_wait_s: float = 300.0, ensemble: bool = False, device: str = "cuda",
               graphs=None) -> int:
    """Run the matrix; returns 1 if any job failed, else 0.

    ``graphs``: optional ``{dataset: Graph}`` (a list of graphs for a
    ``+``-joined dataset) standing for datasets that this machine cannot
    load (no networkx); in-process jobs only, a subprocess loads its dataset
    itself."""
    from gn_ode_sir_tpu_torch.cli import worker

    worker.resolve_device(device)
    if retries and not use_subprocess:
        # a job that died mid-run may leave its process's device state behind:
        # every attempt gets a fresh process
        print("[MONITORER] --retry forces --subprocess (each attempt in a fresh process)")
        use_subprocess = True
    if ensemble:
        # refuse what the worker would refuse (in this process that would end
        # the matrix at the first job) or what the fold would not apply to
        if cfg.model in ("dmp", "rk"):
            raise SystemExit(
                f"--ensemble cannot drive this matrix (model={cfg.model}): the worker "
                "rejects --ensemble for untrained baselines, which have no model init to "
                "repeat")
        if not cfg.many_graph_instances:
            raise SystemExit(
                "--ensemble folds the batched repeat protocol only; the legacy per-trial "
                "node-split fan-out (--per_trial) runs sequential workers — drop one of "
                "the flags")

    all_jobs = _matrix_jobs(cfg, ensemble, graphs)
    failures = 0
    total = len(all_jobs)
    for proc_num, (dataset, stem, path_to_save, trial, hidden, ii, bb, gg,
                   extra, ens) in enumerate(all_jobs, start=1):
        if only and proc_num not in only:
            continue
        argv = build_worker_argv(cfg, dataset, path_to_save, hidden, trial, ii, bb, gg) + [
            *extra, "--device", device]
        print(f"[MONITORER] Started experiment {proc_num}/{total}: model={cfg.model} "
              f"dataset={stem} hidden={hidden}" + (f" ensemble={ens}" if ens > 1 else ""),
              flush=True)
        ckpt_dir = worker.checkpoint_dir_for(path_to_save, trial, cfg.model, dataset,
                                             ensemble=ens)
        ckpt_before = _newest_mtime(ckpt_dir)
        for attempt in range(retries + 1):
            # a retry resumes from this job's periodic checkpoint only if an
            # attempt of this job wrote it: a checkpoint older than the job (a
            # completed earlier run of the same trial) would restore at
            # epoch == epochs, train nothing and report the old result
            attempt_argv = list(argv)
            if attempt > 0 and "--resume" not in attempt_argv:
                now = _newest_mtime(ckpt_dir)
                if now is not None and (ckpt_before is None or now > ckpt_before):
                    attempt_argv.append("--resume")
            try:
                if use_subprocess:
                    rc = subprocess.call(
                        [sys.executable, "-m", "gn_ode_sir_tpu_torch.cli.worker", *attempt_argv])
                    if rc != 0:
                        raise RuntimeError(f"worker exited with {rc}")
                else:
                    worker.main(attempt_argv, graph=(graphs or {}).get(dataset))
                break
            # SystemExit too: an in-process worker signals validation failures
            # and the crash drill by raising it, and one failed experiment must
            # not end the matrix. KeyboardInterrupt still propagates.
            except (Exception, SystemExit) as e:
                if isinstance(e, SystemExit) and e.code in (None, 0):
                    break  # a clean exit is a success
                traceback.print_exc()
                if attempt == retries:
                    print("[MONITORER] Oops! Something broke!", flush=True)
                    failures += 1
                else:
                    print(f"[MONITORER] attempt {attempt + 1}/{retries + 1} failed; "
                          f"retrying in {retry_wait_s:.0f}s", flush=True)
                    time.sleep(retry_wait_s)
    print(f"[MONITORER] Completed {total} procedures, {failures} failures.", flush=True)
    return 1 if failures else 0


def ngraphs_config() -> MatrixConfig:
    """The multi-graph matrix (the reference's ``monitorer-ngraphs.py``): four
    repeats at hidden 8 on five train graphs and an unseen one. The
    reference names ``epinions`` as the unseen graph but ships no pickle of
    it; ``enron``, the largest graph it ships, stands in (as in the JAX
    package)."""
    return MatrixConfig(
        epochs=500,
        lr=1e-3,
        batch_size=8,
        hidden_dim_array=(8, 8, 8, 8),
        datasets_array=(
            "./real_graphs/dolphins+fb-food+fb-social+openflights+wiki-vote+enron",
        ),
        model="ode_nn",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GN-ODE SIR experiment matrix (PyTorch/CUDA port)")
    p.add_argument("--only", nargs="+", type=int, default=[])
    p.add_argument("--subprocess", action="store_true",
                   help="run each experiment in a subprocess (reference behavior)")
    p.add_argument("--ngraphs", action="store_true",
                   help="use the multi-graph matrix defaults (monitorer-ngraphs)")
    p.add_argument("--per_trial", action="store_true",
                   help="legacy per-trial fan-out: one node-split worker per (trial, "
                        "hidden) pair (many_graph_instances=False)")
    p.add_argument("--config", default=None,
                   help="JSON file of MatrixConfig fields (explicit flags win)")
    p.add_argument("--retry", type=int, default=0,
                   help="retry a failed experiment up to N times, in a fresh process "
                        "(forces --subprocess), resuming its periodic checkpoint")
    p.add_argument("--retry_wait", type=float, default=300.0,
                   help="seconds to sleep between retry attempts")
    p.add_argument("--ensemble", action="store_true",
                   help="fold repeats of one hidden size (hidden_dim_array=[8,8,8,8]) "
                        "into one --ensemble worker per group: same K CSV rows. Changes "
                        "--only numbering (fewer procedures).")
    p.add_argument("--model", default=None)
    p.add_argument("--datasets", nargs="+", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--trials", type=int, default=None)
    p.add_argument("--hidden", type=int, nargs="+", default=None)
    p.add_argument("--experiments_root", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every worker runs; cuda raises when no card is visible")
    return p


def main(argv=None) -> int:
    from gn_ode_sir_tpu_torch.cli import apply_data_root_default

    apply_data_root_default()
    args = build_parser().parse_args(argv)
    cfg = ngraphs_config() if args.ngraphs else MatrixConfig()
    if args.config:
        import json

        with open(args.config) as f:
            raw = json.load(f)
        valid = {f.name for f in dataclasses.fields(MatrixConfig)}
        unknown = set(raw) - valid
        if unknown:
            raise SystemExit(f"unknown MatrixConfig fields in {args.config}: {sorted(unknown)}")
        for k, v in raw.items():
            setattr(cfg, k, tuple(v) if isinstance(v, list) else v)
    if args.per_trial:
        cfg.many_graph_instances = False
    for flag, field in (("model", "model"), ("epochs", "epochs"), ("trials", "trials_per_number"),
                        ("experiments_root", "experiments_root"), ("seed", "seed")):
        if getattr(args, flag) is not None:
            setattr(cfg, field, getattr(args, flag))
    if args.datasets:
        cfg.datasets_array = tuple(args.datasets)
    if args.hidden:
        cfg.hidden_dim_array = tuple(args.hidden)
    return run_matrix(cfg, only=tuple(args.only), use_subprocess=args.subprocess,
                      retries=args.retry, retry_wait_s=args.retry_wait,
                      ensemble=args.ensemble, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
