"""Port parity: the GCN and GIN baselines and their trial adapter
(gn_ode_sir_tpu_torch.models.gcn, gin, adapter) against the JAX package on
the CPU: a JAX-initialised parameter tree carried across by
``params_from_numpy``, the forward (1e-5) and the gradient of the L1 loss in
every leaf (1e-4 of the leaf's largest entry) on dense, COO and K1
adjacencies; and the dropout of ``models.common``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.models import GCN as JaxGCN
from gn_ode_sir_tpu.models import GIN as JaxGIN
from gn_ode_sir_tpu.models import TimeUnrolledSIR as JaxTimeUnrolledSIR
from gn_ode_sir_tpu.ops import gcn_norm_edges as jax_gcn_norm_edges
from gn_ode_sir_tpu.ops.adjacency import CooAdj as JaxCooAdj
from gn_ode_sir_tpu.train.loss import l1_sir_loss as jax_l1_sir_loss
from gn_ode_sir_tpu_torch.models import GCN, GIN, TimeUnrolledSIR
from gn_ode_sir_tpu_torch.models.common import dropout
from gn_ode_sir_tpu_torch.ops.adjacency import CooAdj, DenseAdj
from gn_ode_sir_tpu_torch.ops.spmm2 import Spmm2Adj
from gn_ode_sir_tpu_torch.train.checkpoint import (params_from_numpy, params_to_numpy,
                                                   restore_params, save_params, tree_leaves)
from gn_ode_sir_tpu_torch.train.loss import l1_sir_loss

torch.set_num_threads(1)

ATOL, GRAD_RTOL = 1e-5, 1e-4
WINDOW, HIDDEN, BATCH = 5, 6, 3
FAMILIES = {"GCN": (JaxGCN, GCN), "GIN": (JaxGIN, GIN)}


def _models(family, **kw):
    jcls, tcls = FAMILIES[family]
    kw = dict(hidden_dim=HIDDEN, penultimate_dim=3, window=WINDOW, **kw)
    return jcls(**kw), tcls(**kw)


def _edges(jg, family):
    """(src, dst, w): GCN aggregates with normalized weights, GIN the raw sum."""
    if family == "GCN":
        return jax_gcn_norm_edges(jg)
    return jg.src, jg.dst, np.ones(jg.n_edges, np.float32)


def _port_adj(kind, src, dst, w, n):
    if kind == "dense":
        a = np.zeros((n, n), np.float32)
        a[dst, src] = w
        return DenseAdj(torch.as_tensor(a))
    if kind == "coo":
        return CooAdj(torch.as_tensor(src).long(), torch.as_tensor(dst).long(),
                      torch.as_tensor(w), n)
    return Spmm2Adj.from_edges(src, dst, n, w, device="cpu")


def _trial_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    i0 = np.zeros((BATCH, n), np.float32)
    for b in range(BATCH):
        i0[b, rng.choice(n, 2, replace=False)] = 1.0
    labels = rng.dirichlet([2.0, 1.0, 1.0], size=(BATCH, WINDOW, n)).astype(np.float32)
    return (1 - i0, i0, np.zeros_like(i0), rng.uniform(0.1, 0.5, BATCH).astype(np.float32),
            rng.uniform(0.05, 0.4, BATCH).astype(np.float32)), labels


@pytest.mark.parametrize("family", ["GCN", "GIN"])
@pytest.mark.parametrize("kind", ["dense", "coo", "pallas2"])
def test_forward_and_gradients_match_jax(random_graph, family, kind):
    jg, n = random_graph, random_graph.n_nodes
    jgnn, tgnn = _models(family, dropout=0.0)
    jmodel, tmodel = JaxTimeUnrolledSIR(jgnn), TimeUnrolledSIR(tgnn)
    assert tmodel.max_time == jmodel.max_time == WINDOW
    pj = jmodel.init(jax.random.PRNGKey(2))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    src, dst, w = _edges(jg, family)
    jadj = JaxCooAdj(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), n)
    tadj = _port_adj(kind, src, dst, w, n)
    xs, labels = _trial_inputs(n)

    want = np.asarray(jmodel.predict(pj, jadj, *map(jnp.asarray, xs), train=False))
    got = tmodel.predict(pt, tadj, *map(torch.as_tensor, xs), train=False)
    assert got.shape == (WINDOW, BATCH, n, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got[0].numpy(), np.stack(xs[:3], -1))  # the exact t = 0

    jgrads = jax.grad(lambda p: jax_l1_sir_loss(
        jmodel.predict(p, jadj, *map(jnp.asarray, xs), train=True), jnp.asarray(labels)))(pj)
    leaves = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    for _, leaf in tree_leaves(leaves):
        leaf.requires_grad_(True)
    l1_sir_loss(tmodel.predict(leaves, tadj, *map(torch.as_tensor, xs), train=True),
                torch.as_tensor(labels)).backward()
    jflat = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    unused = f"convs/{WINDOW - 1}/"  # the forward stops at layer window - 2
    for path, leaf in tree_leaves(leaves):
        if path.startswith(unused):
            assert leaf.grad is None and not jflat[path].any()
            continue
        scale = max(np.abs(jflat[path]).max(), 1e-6)
        assert np.abs(leaf.grad.numpy() - jflat[path]).max() <= GRAD_RTOL * scale, path


@pytest.mark.parametrize("family", ["GCN", "GIN"])
def test_param_trees_cross_both_ways_and_the_checkpoint(family, tmp_path):
    jgnn, tgnn = _models(family)
    pj = jax.tree_util.tree_map(np.asarray, jgnn.init(jax.random.PRNGKey(0)))
    own = tgnn.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: [(p, tuple(leaf.shape)) for p, leaf in tree_leaves(tree)]
    assert shapes(own) == shapes(pj) and len(own["convs"]) == WINDOW
    if family == "GIN":
        assert (own["convs"][1]["bn2"]["scale"] == 1).all()
        assert not own["convs"][1]["bn2"]["bias"].any()
    again = tgnn.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(own), tree_leaves(again)))
    pt = params_from_numpy(pj, device="cpu")
    back = params_to_numpy(pt)
    assert isinstance(back["convs"], list) and shapes(back) == shapes(pj)
    for (_, a), (_, b) in zip(tree_leaves(back), tree_leaves(pj)):
        assert np.array_equal(a, b)
    save_params(str(tmp_path), pt)
    for (pa, a), (pb, b) in zip(tree_leaves(restore_params(str(tmp_path), device="cpu")),
                                tree_leaves(pt)):
        assert pa == pb and torch.equal(a, b)


def test_adapter_without_rates_matches_jax(random_graph):
    jg, n = random_graph, random_graph.n_nodes
    jgnn, tgnn = _models("GIN", input_dim=3, dropout=0.0)
    jmodel, tmodel = JaxTimeUnrolledSIR(jgnn, with_rates=False), TimeUnrolledSIR(tgnn, False)
    pj = jmodel.init(jax.random.PRNGKey(4))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    src, dst, w = _edges(jg, "GIN")
    xs, _ = _trial_inputs(n, seed=1)
    want = jmodel.predict(pj, JaxCooAdj(jnp.asarray(src), jnp.asarray(dst), None, n),
                          *map(jnp.asarray, xs))
    got = tmodel.predict(pt, _port_adj("dense", src, dst, w, n), *map(torch.as_tensor, xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dropout_with_a_generator():
    x = torch.rand((200, 500)) + 0.5
    gen = torch.Generator().manual_seed(3)
    for out in (dropout(gen, x, 0.3, False), dropout(gen, x, 0.0, True),
                dropout(None, x, 0.3, True)):
        assert out is x  # identity unless training, rate > 0 and a generator
    rate, keep = 0.3, 0.7
    state = gen.get_state()
    out = dropout(gen, x, rate, True)
    kept = out != 0
    share, se = float(kept.float().mean()), (keep * rate / x.numel()) ** 0.5
    assert abs(share - keep) < 3 * se
    torch.testing.assert_close(out[kept], x[kept] / keep)
    gen.set_state(state)
    assert torch.equal(dropout(gen, x, rate, True), out)  # same state, same mask
    assert not torch.equal(dropout(gen, x, rate, True), out)  # the generator moved on


@pytest.mark.parametrize("family", ["GCN", "GIN"])
def test_training_mode_draws_dropout_only_with_a_generator(random_graph, family):
    n = random_graph.n_nodes
    _, tgnn = _models(family, dropout=0.5)
    model = TimeUnrolledSIR(tgnn)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    src, dst, w = _edges(random_graph, family)
    adj = _port_adj("dense", src, dst, w, n)
    xs, _ = _trial_inputs(n)
    xs = tuple(map(torch.as_tensor, xs))
    plain = model.predict(params, adj, *xs, train=False)
    assert torch.equal(model.predict(params, adj, *xs, train=True), plain)
    drop = lambda seed: model.predict(params, adj, *xs, train=True,
                                      rng=torch.Generator().manual_seed(seed))
    a = drop(7)
    assert not torch.equal(a, plain) and torch.equal(a, drop(7)) and not torch.equal(a, drop(8))
    torch.testing.assert_close(a.sum(-1), torch.ones(a.shape[:-1]))
