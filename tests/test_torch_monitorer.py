"""Port parity: the experiment-matrix monitorer (``gn_ode_sir_tpu_torch.cli.
monitorer``): ``random_parameters_sir`` and ``build_worker_argv`` equal the
JAX monitorer's; on networkx graphs pickled in ``tmp_path``, the matrix runs
end to end on the CPU (in this process and in worker processes), ``--only``,
``--per_trial`` (node-split workers), ``--ensemble`` grouping, a worker's
``SystemExit`` caught, and a retry that resumes only its own job's
checkpoint."""

import csv
import os
import pickle
import subprocess as sp
import sys
import time as time_mod

import networkx as nx
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.cli import monitorer as jax_monitorer
from gn_ode_sir_tpu_torch.cli import monitorer, worker
from gn_ode_sir_tpu_torch.graphs import load_graph

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def datasets(tmp_path):
    """Two small networkx pickles: karate (34 nodes) and a 40-node graph."""
    paths = []
    for name, g in (("karate", nx.karate_club_graph()),
                    ("ws40", nx.connected_watts_strogatz_graph(40, 4, 0.2, seed=1))):
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump(g, f)
        paths.append(str(tmp_path / name))
    return paths


def _cfg(tmp_path, datasets, **kw):
    base = dict(epochs=2, trials_per_number=5, hidden_dim_array=(8,),
                datasets_array=tuple(datasets[:1]), sim=50, max_time=5, batch_size=2,
                experiments_root=str(tmp_path / "exp"), seed=3)
    return monitorer.MatrixConfig(**{**base, **kw})


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))[1:]


def test_trial_sampling_and_worker_argv_equal_jax(datasets):
    from gn_ode_sir_tpu.graphs import load_graph as jax_load_graph

    g, jg = load_graph(datasets[0]), jax_load_graph(datasets[0])
    got = monitorer.random_parameters_sir(g, (2, 3), 4, np.random.default_rng(7))
    want = jax_monitorer.random_parameters_sir(jg, (2, 3), 4, np.random.default_rng(7))
    assert got == want
    for kw in ({}, {"out_of_dist": True, "seed": 5}):
        cfg = monitorer.MatrixConfig(**kw)
        jcfg = jax_monitorer.MatrixConfig(**kw)
        args = ("ds", "out", 8, 3, got[0][:2], got[1][:2], got[2][:2])
        assert monitorer.build_worker_argv(cfg, *args) == jax_monitorer.build_worker_argv(
            jcfg, *args)
    defaults = {f: getattr(jax_monitorer.MatrixConfig(), f)
                for f in jax_monitorer.MatrixConfig.__dataclass_fields__}
    assert {f: getattr(monitorer.MatrixConfig(), f) for f in defaults} == defaults
    assert monitorer.ngraphs_config().hidden_dim_array == (8, 8, 8, 8)
    flags = monitorer.build_worker_argv(
        monitorer.MatrixConfig(worker_flags=("--checkpoint_every", 1)), *args)
    assert flags[-2:] == ["--checkpoint_every", "1"]


def test_matrix_only_and_ensemble(tmp_path, datasets, capsys):
    cfg = _cfg(tmp_path, datasets, datasets_array=tuple(datasets), hidden_dim_array=(8, 8))
    assert monitorer.run_matrix(cfg, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Started experiment 4/4:" in out and "0 failures" in out
    exp = tmp_path / "exp" / "Experiments-seed2-karate"
    with open(exp / "initial-seed.pkl", "rb") as f:
        assert len(pickle.load(f)) == 5
    assert [r[0] for r in _rows(exp / "Metrics-trials-karate")] == ["1", "2"]
    # a rerun reloads the persisted trials and --only picks one procedure
    assert monitorer.run_matrix(cfg, only=(3,), device="cpu") == 0
    out = capsys.readouterr().out
    assert "Started experiment 3/4:" in out and "experiment 1/4" not in out
    assert len(_rows(tmp_path / "exp" / "Experiments-seed2-ws40" / "Metrics-trials-ws40")) == 3
    # --ensemble folds the two repeats into one worker writing both rows
    assert monitorer.run_matrix(cfg, ensemble=True, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Started experiment 1/2:" in out and "ensemble=2" in out
    assert [r[0] for r in _rows(exp / "Metrics-trials-karate")] == ["1", "2", "1", "2"]
    with pytest.raises(SystemExit, match="ensemble"):
        monitorer.run_matrix(_cfg(tmp_path, datasets, model="dmp"), ensemble=True, device="cpu")
    with pytest.raises(SystemExit, match="ensemble"):
        monitorer.run_matrix(_cfg(tmp_path, datasets, many_graph_instances=False),
                             ensemble=True, device="cpu")


def test_per_trial_fans_out_node_split_workers(tmp_path, datasets, capsys):
    cfg = _cfg(tmp_path, datasets, trials_per_number=2, epochs=1)
    assert monitorer.main(["--per_trial", "--device", "cpu", "--config", _json(tmp_path, cfg)]) \
        == 0
    out = capsys.readouterr().out
    assert "Started experiment 2/2:" in out
    rows = _rows(tmp_path / "exp" / "Experiments-seed2-karate" / "Metrics-trials-karate")
    assert [r[0] for r in rows] == ["1", "2"] and all(float(r[15]) > 0 for r in rows)


def _json(tmp_path, cfg):
    import dataclasses
    import json

    path = tmp_path / "matrix.json"
    path.write_text(json.dumps({k: list(v) if isinstance(v, tuple) else v
                                for k, v in dataclasses.asdict(cfg).items()}))
    return str(path)


def test_worker_system_exit_is_caught(tmp_path, datasets, capsys, monkeypatch):
    """An in-process worker signals failures by SystemExit: the matrix prints
    the marker line and goes on; SystemExit(0) is a success."""
    calls = []

    def fake_main(argv, graph=None):
        calls.append(argv)
        if len(calls) == 1:
            raise SystemExit("pinned trials < requested")
        if len(calls) == 2:
            raise SystemExit(0)
        return 0

    monkeypatch.setattr(worker, "main", fake_main)
    cfg = _cfg(tmp_path, datasets, hidden_dim_array=(8, 16, 24))
    assert monitorer.run_matrix(cfg, device="cpu") == 1
    out = capsys.readouterr().out
    assert len(calls) == 3 and "Oops! Something broke!" in out and "1 failures" in out
    assert all(a[-2:] == ["--device", "cpu"] for a in calls)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="--device cuda"):
            monitorer.run_matrix(cfg)


def test_retry_resumes_only_its_own_checkpoint(tmp_path, datasets, monkeypatch):
    cfg = _cfg(tmp_path, datasets)
    path_to_save = os.path.join(cfg.experiments_root, "Experiments-seed2-karate")
    ckpt_dir = worker.checkpoint_dir_for(path_to_save, 1, "ode_nn", datasets[0])
    monkeypatch.setattr(time_mod, "sleep", lambda s: None)
    # a checkpoint older than the job; failing attempts write nothing: no --resume
    os.makedirs(ckpt_dir)
    with open(os.path.join(ckpt_dir, "state.pt"), "w") as f:
        f.write("an earlier run")
    old = time_mod.time() - 3600
    os.utime(os.path.join(ckpt_dir, "state.pt"), (old, old))
    argvs = []

    def fail(argv, **kw):
        argvs.append(list(argv))
        return 1

    monkeypatch.setattr(sp, "call", fail)
    assert monitorer.run_matrix(cfg, retries=1, retry_wait_s=0.0, device="cpu") == 1
    assert len(argvs) == 2 and all("--resume" not in a for a in argvs)
    assert argvs[0][:3] == [sys.executable, "-m", "gn_ode_sir_tpu_torch.cli.worker"]
    # the first attempt of this job writes a checkpoint and dies: the retry resumes
    argvs.clear()

    def write_then_fail(argv, **kw):
        argvs.append(list(argv))
        if len(argvs) == 1:
            with open(os.path.join(ckpt_dir, "state.pt"), "w") as f:
                f.write("this job")
            return 17
        return 0

    monkeypatch.setattr(sp, "call", write_then_fail)
    assert monitorer.run_matrix(cfg, retries=1, retry_wait_s=0.0, device="cpu") == 0
    assert "--resume" not in argvs[0] and "--resume" in argvs[1]


def test_crash_drill_in_worker_processes(tmp_path, datasets, capsys, monkeypatch):
    """The drill end to end in real worker processes: the first attempt
    exits with 17 at epoch 1 after its epoch-0 checkpoint, the retry resumes
    it, and the resumed run's CSV row equals an uninterrupted run's."""
    monkeypatch.setenv("PYTHONPATH", REPO)  # the worker processes import the port
    cfg = _cfg(tmp_path, datasets, epochs=3,
               worker_flags=("--checkpoint_every", "1", "--die_at_epoch", "1"))
    assert monitorer.main(["--device", "cpu", "--retry", "1", "--retry_wait", "0",
                           "--config", _json(tmp_path, cfg)]) == 0
    out = capsys.readouterr().out
    assert "attempt 1/2 failed" in out and "0 failures" in out
    save = os.path.join(cfg.experiments_root, "Experiments-seed2-karate")
    resumed = _rows(os.path.join(save, "Metrics-trials-karate"))[-1]
    plain = monitorer.build_worker_argv(cfg, datasets[0], save, 8, 1, *monitorer
                                        ._load_or_create_params(cfg, datasets[0], save))
    i = plain.index("--checkpoint_every")
    assert worker.main(plain[:i] + ["--auto_checkpoint", "0", "--device", "cpu"]) == 0
    again = _rows(os.path.join(save, "Metrics-trials-karate"))[-1]
    assert resumed[:15] == again[:15]  # trial, config, best epoch, val and test loss
