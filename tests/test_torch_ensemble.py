"""Port parity: the K-repeat ensemble (``gn_ode_sir_tpu_torch.train.ensemble``).

- Member j against the port's own ``fit(seed=seeds[j])``: per-epoch train and
  val losses, best epoch and test loss to rtol 2e-5, on the folded route
  (``torch.func.vmap`` over the members, the linear layers member after
  member) and on the per-member route.
- Against the JAX ``fit_ensemble`` from the same initial params: 1e-4
  relative, as ``fit`` is held in ``test_torch_fit.py``.
- The ``vmap`` rule of K1's autograd Function: members folded into one
  launch give per-member K1 (its plain version on the CPU), forward and
  gradient, bit for bit.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from gn_ode_sir_tpu.models.gnode import GNODE as JaxGNODE
from gn_ode_sir_tpu.ops.adjacency import adjacency_from_graph as jax_adjacency
from gn_ode_sir_tpu.train import build_trial_data as jax_build_trial_data
from gn_ode_sir_tpu.train import fit_ensemble as jax_fit_ensemble
import gn_ode_sir_tpu_torch.ops.spmm2 as spmm2_mod
from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.models import GCN, GNODE, TimeUnrolledSIR
from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
from gn_ode_sir_tpu_torch.ops.spmm2 import Spmm2Adj, spmm2_plain
from gn_ode_sir_tpu_torch.train import (build_trial_data, fit, fit_ensemble, init_ensemble,
                                        member_routes, trajectory_bytes)
from gn_ode_sir_tpu_torch.train.checkpoint import params_from_numpy

torch.set_num_threads(1)

RTOL_SELF = 2e-5  # member j against the port's sequential fit
RTOL_JAX = 1e-4  # against the JAX package
SEEDS = [3, 7, 11]
N_TRIALS, MAX_TIME, LR = 10, 6, 1e-2
SPLITS = (np.arange(0, 6), np.arange(6, 8), np.arange(8, 10))


def _port_graph(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    nodes = [sorted(rng.choice(n, 2, replace=False).tolist()) for _ in range(N_TRIALS)]
    beta = rng.uniform(0.1, 0.5, N_TRIALS)
    gamma = rng.uniform(0.05, 0.4, N_TRIALS)
    triples = []
    for _ in range(N_TRIALS):
        p = rng.dirichlet([2.0, 1.0, 1.0], size=(MAX_TIME, n))
        triples.append((p[..., 0], p[..., 1], p[..., 2]))
    return nodes, beta, gamma, triples


def _assert_member_equals_fit(ens, j, res, rtol):
    for (e, tr, va), (e2, tr_e, va_e) in zip(res.history, ens.history):
        assert e == e2
        assert tr_e[j] == pytest.approx(tr, rel=rtol)
        assert va_e[j] == pytest.approx(va, rel=rtol)
    assert int(ens.best_epoch[j]) == res.best_epoch
    assert ens.test_loss[j] == pytest.approx(res.test_loss, rel=rtol)


@pytest.mark.parametrize("model,spmm,route", [
    (GNODE(hidden=8, max_time=MAX_TIME, adjoint="direct"), "dense", "fold"),
    (GNODE(hidden=8, max_time=MAX_TIME, adjoint="checkpoint"), "pallas2", "fold"),
    (GNODE(hidden=8, max_time=MAX_TIME, adjoint="backsolve", method="rk4"), "pallas2",
     "per_member"),
    (TimeUnrolledSIR(GCN(hidden_dim=8, penultimate_dim=4, window=MAX_TIME)), "dense",
     "per_member"),
])
def test_members_equal_sequential_fits(random_graph, model, spmm, route):
    """Each member's trace is the sequential ``fit`` with its seed: GN-ODE
    folds (the checkpoint adjoint trains as direct in the fold); backsolve
    and GCN's dropout take the per-member route."""
    n = random_graph.n_nodes
    data = build_trial_data(n, *_inputs(n))
    adj = adjacency_from_graph(_port_graph(random_graph), kind=spmm, device="cpu")
    opt = lambda leaves: torch.optim.Adam(leaves, lr=LR)
    kw = dict(epochs=3, batch_size=4, verbose=False, track_test_per_trial=True)
    ens = fit_ensemble(model, opt, init_ensemble(model, SEEDS, device="cpu"), data, *SPLITS,
                       lambda gi: adj, seeds=SEEDS, **kw)
    assert ens.routes[0] == route and ens.routes[1] == "fold"
    assert ens.test_loss_all.shape == (len(SEEDS), len(SPLITS[2]))
    for j, s in enumerate(SEEDS):
        res = fit(model, opt, model.init(torch.Generator().manual_seed(s), device="cpu"), data,
                  *SPLITS, lambda gi: adj, seed=s, **kw)
        _assert_member_equals_fit(ens, j, res, RTOL_SELF)
        np.testing.assert_allclose(ens.test_loss_all[j], res.test_loss_all, rtol=RTOL_SELF)


def test_routes_follow_the_arguments(random_graph):
    n = random_graph.n_nodes
    data = build_trial_data(n, *_inputs(n))
    gnode = GNODE(hidden=8, max_time=MAX_TIME)
    tr = SPLITS[0]
    assert member_routes(gnode, data, tr, False) == ("fold", "fold")
    assert member_routes(gnode, data, tr, True) == ("per_member", "fold")
    assert member_routes(GNODE(method="dopri5_adaptive"), data, tr, False) == (
        "per_member", "per_member")
    two = build_trial_data(n, *_inputs(n), graph_idx=[0] * 5 + [1] * 5)
    assert member_routes(gnode, two, tr, False) == ("per_member", "fold")
    one = trajectory_bytes(gnode, 4, n)
    assert one == len(gnode.ts) * 3 * 4 * n * 8 * 4
    assert member_routes(gnode, data, tr, False, members=3, train_bytes=one, eval_bytes=2 * one,
                         budget_bytes=3 * one) == ("fold", "per_member")
    # the trial store shards only over a mesh (tests/test_torch_parallel.py runs one)
    with pytest.raises(ValueError, match="requires a mesh"):
        fit_ensemble(gnode, lambda p: torch.optim.Adam(p), init_ensemble(gnode, [0], device="cpu"),
                     data, *SPLITS, lambda gi: None, seeds=[0], data_axis="data")
    with pytest.raises(ValueError, match="leading axis"):
        fit_ensemble(gnode, lambda p: torch.optim.Adam(p), init_ensemble(gnode, [0], device="cpu"),
                     data, *SPLITS, lambda gi: None, seeds=[0, 1])


def test_ensemble_matches_jax_fit_ensemble(random_graph):
    """From the JAX-initialised stack carried across: per-epoch member losses,
    best epochs and test losses within 1e-4 of the JAX ``fit_ensemble``."""
    n = random_graph.n_nodes
    nodes, beta, gamma, triples = _inputs(n)
    jm = JaxGNODE(hidden=8, max_time=MAX_TIME, adjoint="direct")
    stack = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *[jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.PRNGKey(s))) for s in SEEDS])
    jadj = jax_adjacency(random_graph, kind="dense")
    common = dict(epochs=3, batch_size=4, seeds=SEEDS, verbose=False)
    jres = jax_fit_ensemble(jm, optax.adam(LR), jax.tree_util.tree_map(jax.numpy.asarray, stack),
                            jax_build_trial_data(n, nodes, beta, gamma, triples), *SPLITS,
                            lambda gi, aux: aux["adj"], adj_aux={"adj": jadj}, **common)
    tadj = adjacency_from_graph(_port_graph(random_graph), kind="dense", device="cpu")
    tres = fit_ensemble(GNODE(hidden=8, max_time=MAX_TIME, adjoint="direct"),
                        lambda leaves: torch.optim.Adam(leaves, lr=LR),
                        params_from_numpy(stack, device="cpu"),
                        build_trial_data(n, nodes, beta, gamma, triples), *SPLITS,
                        lambda gi: tadj, **common)
    for (_, jtr, jva), (_, ttr, tva) in zip(jres.history, tres.history):
        np.testing.assert_allclose(ttr, np.asarray(jtr), rtol=RTOL_JAX)
        np.testing.assert_allclose(tva, np.asarray(jva), rtol=RTOL_JAX)
    np.testing.assert_array_equal(tres.best_epoch, np.asarray(jres.best_epoch))
    np.testing.assert_allclose(tres.test_loss, np.asarray(jres.test_loss), rtol=RTOL_JAX)


@pytest.mark.parametrize("member_shape", [(2, 34, 5), (34, 8)])
def test_k1_vmap_rule_folds_members_into_one_launch(karate, member_shape):
    """``torch.func.vmap`` over K members reaches K1's Function once, at
    [K·B, n, h]; forward and gradient equal K1's plain version member by
    member, bit for bit."""
    k = 3
    adj = Spmm2Adj.from_graph(_port_graph(karate), device="cpu")
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((k, *member_shape)), dtype=torch.float32,
                     requires_grad=True)
    g = torch.tensor(rng.standard_normal((k, *member_shape)), dtype=torch.float32)
    seen = []
    apply = spmm2_mod._apply

    def recording(plan, xx, precision, backward):
        seen.append((tuple(xx.shape), backward))
        return apply(plan, xx, precision, backward)

    spmm2_mod._apply = recording
    try:
        y = torch.func.vmap(adj.matvec)(x)
        (dx,) = torch.autograd.grad(y, x, g)
    finally:
        spmm2_mod._apply = apply
    folded = (k * member_shape[0], *member_shape[1:]) if len(member_shape) == 3 else (
        k, *member_shape)
    assert seen == [(folded, False), (folded, True)]
    for j in range(k):
        assert torch.equal(y[j], spmm2_plain(adj.plan, x[j].detach()))
        assert torch.equal(dx[j], spmm2_plain(adj.plan_t, g[j]))
