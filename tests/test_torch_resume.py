"""Periodic checkpoints and exact-trace resume (``fit``, ``fit_ensemble``,
``train.checkpoint``): a run that dies at epoch k (the worker's crash drill
rides the ``metrics_logger`` seam) and resumes from its last checkpoint
reproduces the uninterrupted run's history exactly (bit for bit, on the
CPU), with plain and graph-grouped batches; a NaN test loss (no val
improvement yet) round-trips as NaN; the auto cadence and the final-save
rule follow the JAX package."""

import math

import numpy as np
import pytest
import torch

from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.models import GNODE
from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
from gn_ode_sir_tpu_torch.train import (build_trial_data, fit, fit_ensemble, init_ensemble,
                                        restore_checkpoint, save_checkpoint)
from gn_ode_sir_tpu_torch.train.loop import auto_cadence, final_save_due

torch.set_num_threads(1)

N, T = 10, 5
SPLITS = (np.arange(0, 6), np.arange(6, 8), np.arange(8, 10))
MODEL = GNODE(hidden=8, max_time=T, adjoint="direct")


class _Die:
    def __init__(self, epoch):
        self.epoch = epoch

    def log(self, epoch, **kw):
        if epoch >= self.epoch:
            raise SystemExit(17)


def _data(random_graph, graph_idx=None):
    n = random_graph.n_nodes
    rng = np.random.default_rng(0)
    nodes = [sorted(rng.choice(n, 2, replace=False).tolist()) for _ in range(N)]
    triples = []
    for _ in range(N):
        p = rng.dirichlet([2.0, 1.0, 1.0], size=(T, n))
        triples.append((p[..., 0], p[..., 1], p[..., 2]))
    data = build_trial_data(n, nodes, rng.uniform(0.1, 0.5, N), rng.uniform(0.05, 0.4, N),
                            triples, graph_idx=graph_idx)
    adj = adjacency_from_graph(Graph(n_nodes=n, src=random_graph.src, dst=random_graph.dst),
                               kind="pallas2", device="cpu")
    return data, adj


@pytest.mark.parametrize("batch_by_graph", [False, True])
def test_fit_crash_and_resume_reproduce_the_trace(random_graph, tmp_path, batch_by_graph):
    data, adj = _data(random_graph, graph_idx=[0, 1] * 5 if batch_by_graph else None)
    opt = lambda leaves: torch.optim.Adam(leaves, lr=1e-2)
    p0 = MODEL.init(torch.Generator().manual_seed(0), device="cpu")
    kw = dict(epochs=5, batch_size=2, seed=4, verbose=False, batch_by_graph=batch_by_graph,
              track_test_per_trial=True)
    full = fit(MODEL, opt, p0, data, *SPLITS, lambda gi: adj, **kw)
    with pytest.raises(SystemExit):
        fit(MODEL, opt, p0, data, *SPLITS, lambda gi: adj, **kw, checkpoint_dir=str(tmp_path),
            checkpoint_every=1, metrics_logger=_Die(3))
    assert restore_checkpoint(str(tmp_path))["epoch"] == 2
    res = fit(MODEL, opt, p0, data, *SPLITS, lambda gi: adj, **kw, checkpoint_dir=str(tmp_path),
              checkpoint_every=1, resume=True)
    assert res.history == full.history[3:]
    assert (res.best_epoch, res.best_val_loss, res.test_loss) == (
        full.best_epoch, full.best_val_loss, full.test_loss)
    np.testing.assert_array_equal(res.test_loss_all, full.test_loss_all)
    for k in ("func", "dec1"):
        assert torch.equal(res.params[k]["w"], full.params[k]["w"])
        assert torch.equal(res.best_params[k]["w"], full.best_params[k]["w"])
    assert restore_checkpoint(str(tmp_path))["epoch"] == 4


def test_fit_ensemble_crash_and_resume_reproduce_the_trace(random_graph, tmp_path):
    data, adj = _data(random_graph)
    opt = lambda leaves: torch.optim.Adam(leaves, lr=1e-2)
    seeds = [1, 2]
    stack = init_ensemble(MODEL, seeds, device="cpu")
    kw = dict(seeds=seeds, epochs=4, batch_size=2, verbose=False)
    full = fit_ensemble(MODEL, opt, stack, data, *SPLITS, lambda gi: adj, **kw)
    with pytest.raises(SystemExit):
        fit_ensemble(MODEL, opt, stack, data, *SPLITS, lambda gi: adj, **kw,
                     checkpoint_dir=str(tmp_path), checkpoint_every=1, metrics_logger=_Die(2))
    res = fit_ensemble(MODEL, opt, stack, data, *SPLITS, lambda gi: adj, **kw,
                       checkpoint_dir=str(tmp_path), checkpoint_every=1, resume=True)
    assert [h[0] for h in res.history] == [2, 3]
    for (e, tr, va), (e2, tr2, va2) in zip(res.history, full.history[2:]):
        assert e == e2 and np.array_equal(tr, tr2) and np.array_equal(va, va2)
    np.testing.assert_array_equal(res.best_epoch, full.best_epoch)
    np.testing.assert_array_equal(res.test_loss, full.test_loss)
    assert torch.equal(res.params["func"]["w"], full.params["func"]["w"])


def test_nan_test_loss_round_trips(tmp_path):
    """No val improvement yet: the test loss is NaN, and a restore gives NaN
    back, not a perfect score; numpy arrays come back as tensors."""
    save_checkpoint(str(tmp_path), {"test_loss": float("nan"), "epoch": 0,
                                    "best_val": np.array([np.inf, 0.5]),
                                    "params": {"w": torch.ones(2)}})
    st = restore_checkpoint(str(tmp_path))
    assert math.isnan(st["test_loss"]) and st["epoch"] == 0
    assert torch.equal(st["best_val"], torch.tensor([np.inf, 0.5], dtype=torch.float64))
    assert not (tmp_path / "state.pt.tmp").exists()


def test_auto_cadence_and_final_save_rule():
    # three epochs of 10 s projecting a 1,000 s run past 600 s: every 30 epochs
    assert auto_cadence("d", 0, 600.0, 2, 0, 100, [20.0, 10.0, 10.0], False) == 30
    assert auto_cadence("d", 0, 6000.0, 2, 0, 100, [20.0, 10.0, 10.0], False) == 0
    assert auto_cadence("d", 5, 600.0, 2, 0, 100, [20.0, 10.0, 10.0], False) == 5
    assert auto_cadence("d", 0, 600.0, 1, 0, 100, [20.0, 10.0], False) == 0
    # explicit directory: saved; armed by the auto cadence alone and short: not,
    # unless a state is already on disk
    assert final_save_due("d", 3, 0, 0, False, 0.0)
    assert not final_save_due("d", 3, 0, 0, False, 600.0)
    assert final_save_due("d", 3, 0, 0, True, 600.0)
    assert not final_save_due("d", 3, 3, 1, True, 0.0)
    assert not final_save_due(None, 3, 0, 1, False, 0.0)
