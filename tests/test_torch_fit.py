"""Port parity: ``gn_ode_sir_tpu_torch.train.fit`` against the JAX ``fit``.

Both start from the same params (JAX-initialised, carried across with
``params_from_numpy``), the same labels (numpy, from a seed) and the same
seed, so ``default_rng`` draws the same batch orders. The JAX side trains
with ``optax.adam``, the port with ``torch.optim.Adam``: per-epoch train and
val losses must agree within 1e-4 relative, ``best_epoch`` must be equal and
``test_loss`` within 1e-4 relative. All in float32 on the CPU.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from gn_ode_sir_tpu.models.gnode import GNODE as JaxGNODE
from gn_ode_sir_tpu.ops.adjacency import adjacency_from_graph as jax_adjacency
from gn_ode_sir_tpu.ops.pallas_spmm2 import Pallas2Adj
from gn_ode_sir_tpu.train import build_trial_data as jax_build_trial_data
from gn_ode_sir_tpu.train import fit as jax_fit
from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.models.gnode import GNODE
from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
from gn_ode_sir_tpu_torch.train import build_trial_data, fit
from gn_ode_sir_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

RTOL = 1e-4
N_TRIALS, MAX_TIME, HIDDEN, EPOCHS, LR = 10, 6, 8, 3, 1e-2
SPLITS = (np.arange(0, 6), np.arange(6, 8), np.arange(8, 10))


def _port_graph(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


def _trial_inputs(n, seed=0):
    """Seed sets, rates and smooth pseudo-labels (probabilities that sum to
    1 per node and time), all from one numpy seed."""
    rng = np.random.default_rng(seed)
    nodes = [sorted(rng.choice(n, 2, replace=False).tolist()) for _ in range(N_TRIALS)]
    beta = rng.uniform(0.1, 0.5, N_TRIALS)
    gamma = rng.uniform(0.05, 0.4, N_TRIALS)
    triples = []
    for _ in range(N_TRIALS):
        p = rng.dirichlet([2.0, 1.0, 1.0], size=(MAX_TIME, n))  # [T, n, 3]
        triples.append((p[..., 0], p[..., 1], p[..., 2]))
    return nodes, beta, gamma, triples


def _both_fits(jg, *, batch_size, adjoint, spmm="dense", **kw):
    nodes, beta, gamma, triples = _trial_inputs(jg.n_nodes)
    jmodel = JaxGNODE(hidden=HIDDEN, max_time=MAX_TIME, adjoint=adjoint)
    tmodel = GNODE(hidden=HIDDEN, max_time=MAX_TIME, adjoint=adjoint)
    pj = jmodel.init(jax.random.PRNGKey(3))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    if spmm == "pallas2":
        jadj = Pallas2Adj.from_graph(jg, k_edges=16, r_rows=8)
    else:
        jadj = jax_adjacency(jg, kind=spmm)
    tadj = adjacency_from_graph(_port_graph(jg), kind=spmm, device="cpu")
    common = dict(epochs=EPOCHS, batch_size=batch_size, seed=5, verbose=False, **kw)
    jres = jax_fit(jmodel, optax.adam(LR), pj,
                   jax_build_trial_data(jg.n_nodes, nodes, beta, gamma, triples),
                   *SPLITS, lambda gi, aux: aux["adj"], adj_aux={"adj": jadj}, **common)
    tres = fit(tmodel, lambda leaves: torch.optim.Adam(leaves, lr=LR), pt,
               build_trial_data(jg.n_nodes, nodes, beta, gamma, triples),
               *SPLITS, lambda gi: tadj, **common)
    return jres, tres, pt


@pytest.mark.parametrize("batch_size", [1, 4])
@pytest.mark.parametrize("adjoint", ["direct", "checkpoint"])
def test_fit_matches_jax(random_graph, batch_size, adjoint):
    """3 epochs on gnp50; batch size 4 pads the last batch of 6 train trials."""
    jres, tres, pt = _both_fits(random_graph, batch_size=batch_size, adjoint=adjoint)
    assert len(tres.history) == len(jres.history) == EPOCHS
    for (je, jtr, jva), (te, ttr, tva) in zip(jres.history, tres.history):
        assert je == te
        assert ttr == pytest.approx(jtr, rel=RTOL)
        assert tva == pytest.approx(jva, rel=RTOL)
    assert tres.best_epoch == jres.best_epoch
    assert tres.best_val_loss == pytest.approx(jres.best_val_loss, rel=RTOL)
    assert tres.test_loss == pytest.approx(jres.test_loss, rel=RTOL)
    assert len(tres.epoch_times) == EPOCHS
    # the losses moved, and the caller's params were left untouched
    assert tres.history[0][1] != tres.history[-1][1]
    final = params_to_numpy(tres.params)
    start = params_to_numpy(pt)
    assert np.abs(final["func"]["w"] - start["func"]["w"]).max() > 0
    want = jax.tree_util.tree_map(np.asarray, jres.params)
    for k in want:
        for kk in want[k]:
            if (k, kk) == ("dec2", "b"):
                # one shift of all three logits, which the softmax ignores:
                # its gradient is rounding noise, and Adam turns noise into
                # steps of +-lr that change no output
                continue
            np.testing.assert_allclose(final[k][kk], want[k][kk], rtol=0, atol=2e-4)


def test_fit_through_k1_adjacency_matches_jax(random_graph):
    """Training through the K1 adjacency (its autograd Function, plain
    version on the CPU) against the JAX Pallas2Adj with its custom VJP."""
    jres, tres, _ = _both_fits(random_graph, batch_size=2, adjoint="direct", spmm="pallas2")
    for (_, jtr, jva), (_, ttr, tva) in zip(jres.history, tres.history):
        assert ttr == pytest.approx(jtr, rel=RTOL)
        assert tva == pytest.approx(jva, rel=RTOL)
    assert tres.test_loss == pytest.approx(jres.test_loss, rel=RTOL)


def test_fit_per_trial_test_losses_and_best_params(random_graph):
    jres, tres, _ = _both_fits(random_graph, batch_size=2, adjoint="direct",
                               track_test_per_trial=True)
    np.testing.assert_allclose(tres.test_loss_all, np.asarray(jres.test_loss_all), rtol=RTOL)
    assert tres.test_loss_all.shape == (len(SPLITS[2]),)
    best = params_to_numpy(tres.best_params)
    want = jax.tree_util.tree_map(np.asarray, jres.best_params)
    np.testing.assert_allclose(best["dec1"]["w"], want["dec1"]["w"], atol=2e-4)


def test_fit_padded_evaluation_batches_match_jax(random_graph):
    """An evaluation batch size that divides neither the val nor the test
    split: the padding rows weigh nothing on either side."""
    jres, tres, _ = _both_fits(random_graph, batch_size=4, adjoint="direct",
                               eval_batch_size=3)
    for (_, jtr, jva), (_, ttr, tva) in zip(jres.history, tres.history):
        assert ttr == pytest.approx(jtr, rel=RTOL)
        assert tva == pytest.approx(jva, rel=RTOL)
    assert tres.test_loss == pytest.approx(jres.test_loss, rel=RTOL)


class _Recorder:
    def __init__(self):
        self.rows = []

    def log(self, **kw):
        self.rows.append(kw)


def test_fit_metrics_logger_and_unported_arguments(random_graph, tmp_path):
    n = random_graph.n_nodes
    nodes, beta, gamma, triples = _trial_inputs(n)
    model = GNODE(hidden=HIDDEN, max_time=MAX_TIME, adjoint="direct")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    adj = adjacency_from_graph(_port_graph(random_graph), device="cpu")
    data = build_trial_data(n, nodes, beta, gamma, triples)
    opt = lambda leaves: torch.optim.Adam(leaves, lr=LR)
    rec = _Recorder()
    res = fit(model, opt, params, data, *SPLITS, lambda gi: adj, epochs=2,
              batch_size=3, verbose=False, metrics_logger=rec)
    assert [r["epoch"] for r in rec.rows] == [0, 1]
    assert set(rec.rows[0]) == {"epoch", "train_loss", "val_loss", "epoch_s"}
    assert res.history[1][1] == rec.rows[1]["train_loss"]
    assert "state" in res.opt_state
    # the four checkpoint keywords save and resume (the exact trace is held in
    # test_torch_resume.py); profile_dir traces its epoch range
    state = tmp_path / "state.pt"
    fit(model, opt, params, data, *SPLITS, lambda gi: adj, epochs=1, verbose=False,
        checkpoint_dir=str(tmp_path), checkpoint_auto_s=600.0)  # auto alone: a short run
    assert not state.exists()  # does not pay for a save
    fit(model, opt, params, data, *SPLITS, lambda gi: adj, epochs=1, verbose=False,
        checkpoint_dir=str(tmp_path))
    assert state.exists()
    more = fit(model, opt, params, data, *SPLITS, lambda gi: adj, epochs=3, verbose=False,
               checkpoint_dir=str(tmp_path), checkpoint_every=2, resume=True)
    assert [h[0] for h in more.history] == [1, 2]
    assert torch.load(state, weights_only=True)["epoch"] == 2
    fit(model, opt, params, data, *SPLITS, lambda gi: adj, epochs=1,
        profile_dir=str(tmp_path / "prof"), profile_epochs=(0, 0))
    assert list((tmp_path / "prof").glob("*.pt.trace.json"))
