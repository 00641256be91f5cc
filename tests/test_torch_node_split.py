"""Port parity: the legacy node-split protocol (``train.node_split``) against
the JAX package: the reference's seeded node permutation exactly, and
``fit_node_split`` (C6: relu, rk4, layer-normed derivative, and the
3-feature GCN) from the same initial params, per-epoch train and val losses
over 3 epochs and the test loss within 1e-4 relative. Adam at lr 1e-3: C6
amplifies float32 rounding along its trajectory (ROADMAP.md Queue 3); at
lr 1e-2 the third update's rounding moves the test loss by 0.7%."""

import jax
import numpy as np
import optax
import pytest
import torch

from gn_ode_sir_tpu.models import GCN as JaxGCN
from gn_ode_sir_tpu.models import TimeUnrolledSIR as JaxTimeUnrolledSIR
from gn_ode_sir_tpu.models.gnode import legacy_dense_gnode as jax_legacy
from gn_ode_sir_tpu.ops.adjacency import DenseAdj as JaxDenseAdj
from gn_ode_sir_tpu.ops.adjacency import adjacency_from_graph as jax_adjacency
from gn_ode_sir_tpu.ops.spmm import gcn_norm_edges as jax_gcn_norm_edges
from gn_ode_sir_tpu.train.node_split import fit_node_split as jax_fit_node_split
from gn_ode_sir_tpu.train.node_split import node_split_indices as jax_node_split_indices
from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.models import GCN, TimeUnrolledSIR
from gn_ode_sir_tpu_torch.models.gnode import legacy_dense_gnode
from gn_ode_sir_tpu_torch.ops.adjacency import DenseAdj, adjacency_from_graph
from gn_ode_sir_tpu_torch.train import fit_node_split, node_split_indices
from gn_ode_sir_tpu_torch.train.checkpoint import params_from_numpy

torch.set_num_threads(1)

RTOL = 1e-4


@pytest.mark.parametrize("n,ratios", [(34, (0.6, 0.2, 0.2)), (101, (0.5, 0.3, 0.2))])
def test_node_split_indices_equal_jax(n, ratios):
    for got, want in zip(node_split_indices(n, ratios), jax_node_split_indices(n, ratios)):
        np.testing.assert_array_equal(got, want)


def _gcn_dense(g):
    import jax.numpy as jnp

    src, dst, w = jax_gcn_norm_edges(g)
    a = np.zeros((g.n_nodes, g.n_nodes), np.float32)
    a[dst, src] = w
    return JaxDenseAdj(jnp.asarray(a)), DenseAdj(torch.as_tensor(a))


@pytest.mark.parametrize("family", ["C6", "GCN"])
def test_fit_node_split_matches_jax(karate, family):
    g = karate
    max_time = 6
    rng = np.random.default_rng(2)
    labels = rng.dirichlet([2.0, 1.0, 1.0], size=(max_time, g.n_nodes)).astype(np.float32)
    i0 = np.zeros(g.n_nodes, np.float32)
    i0[[3, 12]] = 1.0
    state = (1.0 - i0, i0, np.zeros_like(i0))
    if family == "C6":
        jm = jax_legacy(hidden=8, max_time=max_time)
        tm = legacy_dense_gnode(hidden=8, max_time=max_time)
        jadj = jax_adjacency(g)
        tadj = adjacency_from_graph(Graph(n_nodes=g.n_nodes, src=g.src, dst=g.dst),
                                    device="cpu")
        seed = 0
    else:  # dropout is off in the node-split forward (as in the reference)
        jm = JaxTimeUnrolledSIR(JaxGCN(input_dim=3, hidden_dim=8, penultimate_dim=4,
                                       window=max_time), with_rates=False)
        tm = TimeUnrolledSIR(GCN(input_dim=3, hidden_dim=8, penultimate_dim=4,
                                 window=max_time), with_rates=False)
        jadj, tadj = _gcn_dense(g)
        seed = 1
    pj = jm.init(jax.random.PRNGKey(seed))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    split = dict(zip(("idx_train", "idx_val", "idx_test"), node_split_indices(g.n_nodes)))
    want = jax_fit_node_split(jm, optax.adam(1e-3), pj, jadj, *state, 0.3, 0.1, labels,
                              epochs=3, verbose=False, **split)
    got = fit_node_split(tm, lambda leaves: torch.optim.Adam(leaves, lr=1e-3), pt, tadj,
                         *state, 0.3, 0.1, labels, epochs=3, verbose=False, **split)
    assert len(got.history) == len(want.history) == 3
    for (e, tr, va), (e2, jtr, jva) in zip(got.history, want.history):
        assert e == e2
        assert tr == pytest.approx(jtr, rel=RTOL)
        assert va == pytest.approx(jva, rel=RTOL)
    assert got.best_epoch == want.best_epoch
    assert got.test_loss == pytest.approx(want.test_loss, rel=RTOL)
    # the loss covers t = 0, where the state is given: it moves training
    assert got.history[-1][1] != got.history[0][1]
