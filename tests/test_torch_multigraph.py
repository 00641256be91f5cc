"""Port parity: multi-graph training (gn_ode_sir_tpu_torch.train.multigraph
and the multi-graph surface of ``fit``) against the JAX package on the CPU.

Three graphs of uneven size, the last (the unseen evaluation graph) wider
than 128 nodes so that the train-side node view is narrower than the padding.
The JAX side runs its Pallas backend in interpret mode; the port's K1 runs
its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gn_ode_sir_tpu.train.multigraph as jax_mg
from gn_ode_sir_tpu.graphs import pad_graphs as jax_pad_graphs
from gn_ode_sir_tpu.graphs.graph import graph_from_edges as jax_graph_from_edges
from gn_ode_sir_tpu.models import GCN as JaxGCN
from gn_ode_sir_tpu.models import GNODE as JaxGNODE
from gn_ode_sir_tpu.models import TimeUnrolledSIR as JaxTimeUnrolledSIR
from gn_ode_sir_tpu.train import build_trial_data as jax_build_trial_data
from gn_ode_sir_tpu.train import fit as jax_fit
from gn_ode_sir_tpu_torch.graphs import graph_from_edges, pad_graphs
from gn_ode_sir_tpu_torch.models import GCN, GNODE, TimeUnrolledSIR
from gn_ode_sir_tpu_torch.ops import gcn_norm_edges, spmm_coo
from gn_ode_sir_tpu_torch.ops.adjacency import CooAdj, DenseAdj
from gn_ode_sir_tpu_torch.ops.spmm2 import Spmm2Adj
from gn_ode_sir_tpu_torch.train import (MultigraphConnectivity, assemble_multigraph_trials,
                                        build_trial_data, fit, multigraph_adj_fns,
                                        multigraph_auto_fns, multigraph_pallas2_fns,
                                        multigraph_split, resolve_mg_kind)
from gn_ode_sir_tpu_torch.train import multigraph as mg
from gn_ode_sir_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy, tree_leaves

torch.set_num_threads(1)

RTOL = 1e-4
SIZES = ((13, 20), (30, 70), (140, 260))  # (nodes, undirected edges); the last is unseen
COUNTS = (5, 4, 6)  # trials per graph
MAX_TIME, HIDDEN, EPOCHS, LR = 4, 8, 3, 1e-2
PALLAS_KW = dict(k_edges=32, r_rows=8, interpret=True)


@pytest.fixture(scope="module")
def graphs():
    jgs, tgs = [], []
    for k, (n, m) in enumerate(SIZES):
        rng = np.random.default_rng(k)
        e = np.concatenate([rng.integers(0, n, (m, 2)), [[1, 1], [n - 1, n - 1]]])
        jgs.append(jax_graph_from_edges(n, e, name=f"g{k}"))
        tgs.append(graph_from_edges(n, e, name=f"g{k}"))
    return jgs, tgs


@pytest.fixture(scope="module")
def batches(graphs):
    return jax_pad_graphs(graphs[0]), pad_graphs(graphs[1])


@pytest.fixture(scope="module")
def trials(graphs):
    """Seed sets, rates, smooth pseudo-labels and graph ids from one seed."""
    rng = np.random.default_rng(11)
    nodes, triples, gidx = [], [], []
    for g_i, ((n, _), c) in enumerate(zip(SIZES, COUNTS)):
        for _ in range(c):
            nodes.append(sorted(rng.choice(n, 2, replace=False).tolist()))
            p = rng.dirichlet([2.0, 1.0, 1.0], size=(MAX_TIME, n))
            triples.append((p[..., 0], p[..., 1], p[..., 2]))
            gidx.append(g_i)
    total = sum(COUNTS)
    return nodes, rng.uniform(0.1, 0.5, total), rng.uniform(0.05, 0.4, total), triples, gidx


def test_split_and_train_bucket_equal_jax(batches):
    jb, tb = batches
    for counts, ev in (([36, 36, 120], -1), ([3, 5, 4], 0), ([2, 7], 1), (list(COUNTS), -1)):
        for a, b in zip(jax_mg.multigraph_split(counts, ev), multigraph_split(counts, ev)):
            assert np.array_equal(a, b)
    tr, va, te = multigraph_split(COUNTS)
    assert tr.tolist() == list(range(9)) and va.tolist() == [9, 10, 11] and te.tolist() == [12, 13, 14]
    for ev in (-1, 0, 1):
        want, got = jax_mg._train_bucket(jb, ev), mg._train_bucket(tb, ev)
        assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
        assert np.array_equal(got[2], want[2])
    assert mg._train_bucket(tb, -1)[3] == 128 < tb.n_max == 144  # rounded up to 128
    assert mg._train_bucket(tb, 0)[3] == tb.n_max  # capped at the padding


def test_resolve_mg_kind_on_both_sides_of_the_limit(batches, monkeypatch):
    _, tb = batches
    assert mg.MG_DENSE_BYTES_LIMIT == jax_mg.MG_DENSE_BYTES_LIMIT == 2 << 30
    assert resolve_mg_kind(tb) == "dense" and resolve_mg_kind(tb, gcn_normalized=True) == "dense"
    stack = 3 * tb.n_max * tb.n_max
    monkeypatch.setattr(mg, "MG_DENSE_BYTES_LIMIT", 2 * stack)  # the bf16 {0,1} stack just fits
    assert resolve_mg_kind(tb) == "dense" and resolve_mg_kind(tb, gcn_normalized=True) == "pallas2"
    monkeypatch.setattr(mg, "MG_DENSE_BYTES_LIMIT", 2 * stack - 1)
    assert resolve_mg_kind(tb) == "pallas2"
    conn = multigraph_auto_fns(tb, device="cpu")
    assert isinstance(conn, MultigraphConnectivity) and conn.kind == "pallas2"
    assert conn.batch_by_graph and conn.eval_adj_fn is not conn.adj_fn
    assert conn.adj_fn.n_view == 128 and conn.adj_fn.valid_train_graphs == {0, 1}
    assert set(conn.fit_kwargs()) == {"adj_fn", "eval_adj_fn", "node_mask_fn", "batch_by_graph"}
    with pytest.raises(ValueError, match="multigraph_auto_fns"):
        multigraph_adj_fns(tb, kind="auto", device="cpu")
    monkeypatch.setattr(mg, "MG_DENSE_BYTES_LIMIT", 2 << 30)
    dense = multigraph_auto_fns(tb, device="cpu")
    assert dense.kind == "dense" and not dense.batch_by_graph and dense.adj_fn.n_view == 128
    assert dense.eval_adj_fn.stack.dtype == torch.float32  # under 512 MiB the stack stays f32
    with pytest.warns(UserWarning, match="train_node_view"):
        multigraph_auto_fns(tb, kind="coo", train_node_view=True, device="cpu")
    with pytest.warns(UserWarning, match="precision"):
        multigraph_auto_fns(tb, kind="dense", precision="bf16", device="cpu")


def _jax_conn(jb, kind, gcn_normalized, **kw):
    extra = PALLAS_KW if kind == "pallas2" else {}
    return jax_mg.multigraph_auto_fns(jb, kind=kind, gcn_normalized=gcn_normalized,
                                      **extra, **kw)


@pytest.mark.parametrize("gcn_normalized", [False, True])
@pytest.mark.parametrize("kind", ["dense", "coo", "pallas2"])
def test_adj_fns_equal_each_graphs_spmm_and_jax(graphs, batches, kind, gcn_normalized):
    (_, tgs), (jb, tb) = graphs, batches
    conn = multigraph_auto_fns(tb, kind=kind, gcn_normalized=gcn_normalized, device="cpu")
    jconn = _jax_conn(jb, kind, gcn_normalized)
    jaux = jax.tree_util.tree_map(jnp.asarray, jconn.aux)
    assert conn.kind == jconn.kind == kind and conn.batch_by_graph == jconn.batch_by_graph
    want_type = {"dense": DenseAdj, "coo": CooAdj, "pallas2": Spmm2Adj}[kind]
    rng = np.random.default_rng(5)
    for g_i, g in enumerate(tgs):
        gi = np.full(2, g_i)
        src, dst, w = gcn_norm_edges(g) if gcn_normalized else (g.src, g.dst, None)
        sides = [(conn.eval_adj_fn, jconn.eval_adj_fn, tb.n_max)]
        if g_i != 2:  # the train side knows the train graphs only, at its own width
            sides.append((conn.adj_fn, jconn.adj_fn, getattr(conn.adj_fn, "n_view", tb.n_max)))
        for fn, jfn, width in sides:
            x = rng.standard_normal((2, width, 5)).astype(np.float32)
            x[:, g.n_nodes:] = 0.0  # padding rows hold nothing in a real batch
            adj = fn(gi)
            assert isinstance(adj, want_type)
            got = adj.matvec(torch.as_tensor(x)).numpy()
            want = np.asarray(jfn(jnp.asarray(gi), jaux).matvec(jnp.asarray(x)))
            assert got.shape == want.shape == x.shape
            np.testing.assert_allclose(got, want, atol=1e-5)
            for b in range(2):
                one = spmm_coo(torch.as_tensor(src).long(), torch.as_tensor(dst).long(),
                               torch.as_tensor(x[b, :g.n_nodes]), g.n_nodes,
                               None if w is None else torch.as_tensor(w)).numpy()
                np.testing.assert_allclose(got[b, :g.n_nodes], one, atol=1e-5)
                assert not got[b, g.n_nodes:].any()
    mask = conn.node_mask_fn(np.array([0, 2]))
    assert mask.shape == (2, tb.n_max) and mask.sum(1).tolist() == [13, 140]
    if kind != "pallas2":  # a mixed-graph minibatch: each row its own graph
        x = rng.standard_normal((3, tb.n_max, 4)).astype(np.float32)
        gi = np.array([2, 0, 1])
        got = conn.eval_adj_fn(gi).matvec(torch.as_tensor(x)).numpy()
        want = np.asarray(jconn.eval_adj_fn(jnp.asarray(gi), jaux).matvec(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas2_plans_cover_real_edges_only(graphs, batches):
    (_, tgs), (_, tb) = graphs, batches
    tr_fn, ev_fn, _ = multigraph_pallas2_fns(tb, gcn_normalized=True, train_node_view=True,
                                             device="cpu")
    for g_i in range(3):
        adj = ev_fn(np.array([g_i]))
        loops = int((tgs[g_i].src == tgs[g_i].dst).sum())  # dropped, then one per node added
        assert loops >= 2
        assert adj.plan.src.numel() == tb.n_edges[g_i] - loops + tb.n_nodes[g_i]
        assert adj.n_nodes == tb.n_max and (adj.plan.w > 0).all()
    assert tr_fn(np.array([1, 1])).n_nodes == 128
    full_tr, _, _ = multigraph_pallas2_fns(tb, device="cpu")  # the view is off by default
    assert not hasattr(full_tr, "n_view") and full_tr(np.array([0])).n_nodes == tb.n_max
    assert full_tr.valid_train_graphs == {0, 1} and full_tr.requires_grouped_batches


def _data(trials, n_max, build):
    nodes, beta, gamma, triples, gidx = trials
    return build(n_max, nodes, beta, gamma, triples, graph_idx=gidx, n_pad=n_max)


def _port_fit(model, params, data, conn, **kw):
    kw = {**conn.fit_kwargs(), **kw}
    return fit(model, lambda leaves: torch.optim.Adam(leaves, lr=LR), params, data,
               *multigraph_split(COUNTS), epochs=EPOCHS, batch_size=2, seed=5,
               verbose=False, **kw)


def _assert_histories_match(jres, tres):
    assert len(tres.history) == len(jres.history) == EPOCHS
    for (je, jtr, jva), (te, ttr, tva) in zip(jres.history, tres.history):
        assert je == te
        assert ttr == pytest.approx(jtr, rel=RTOL)
        assert tva == pytest.approx(jva, rel=RTOL)
    assert tres.best_epoch == jres.best_epoch
    assert tres.test_loss == pytest.approx(jres.test_loss, rel=RTOL)


@pytest.mark.parametrize("kind", ["dense", "coo", "pallas2"])
def test_multigraph_fit_matches_jax(batches, trials, kind):
    jb, tb = batches
    jmodel = JaxGNODE(hidden=HIDDEN, max_time=MAX_TIME, adjoint="direct")
    tmodel = GNODE(hidden=HIDDEN, max_time=MAX_TIME, adjoint="direct")
    pj = jmodel.init(jax.random.PRNGKey(3))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    jres = jax_fit(jmodel, optax.adam(LR), pj, _data(trials, jb.n_max, jax_build_trial_data),
                   *jax_mg.multigraph_split(COUNTS), **_jax_conn(jb, kind, False).fit_kwargs(),
                   epochs=EPOCHS, batch_size=2, seed=5, verbose=False)
    conn = multigraph_auto_fns(tb, kind=kind, device="cpu")
    tres = _port_fit(tmodel, pt, _data(trials, tb.n_max, build_trial_data), conn)
    _assert_histories_match(jres, tres)
    assert tres.history[0][1] != tres.history[-1][1]
    final, want = params_to_numpy(tres.params), jax.tree_util.tree_map(np.asarray, jres.params)
    for path, leaf in tree_leaves(want):
        if path == "dec2/b":
            # one shift of all three logits, which the softmax ignores: its
            # gradient is rounding noise, and Adam turns noise into steps of
            # +-lr that change no output
            continue
        np.testing.assert_allclose(dict(tree_leaves(final))[path], leaf, rtol=0, atol=2e-4)


@pytest.mark.parametrize("kind", ["dense", "pallas2"])
def test_multigraph_gcn_fit_matches_jax(batches, trials, kind):
    """GCN on the normalized stack and on K1 with the normalized weights
    (grouped minibatches there, so each backend has its own JAX run)."""
    jb, tb = batches
    kw = dict(hidden_dim=HIDDEN, penultimate_dim=4, window=MAX_TIME, dropout=0.0)
    jmodel, tmodel = JaxTimeUnrolledSIR(JaxGCN(**kw)), TimeUnrolledSIR(GCN(**kw))
    pj = jmodel.init(jax.random.PRNGKey(1))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    jres = jax_fit(jmodel, optax.adam(LR), pj, _data(trials, jb.n_max, jax_build_trial_data),
                   *jax_mg.multigraph_split(COUNTS), **_jax_conn(jb, kind, True).fit_kwargs(),
                   epochs=EPOCHS, batch_size=2, seed=5, verbose=False)
    conn = multigraph_auto_fns(tb, kind=kind, gcn_normalized=True, device="cpu")
    tres = _port_fit(tmodel, pt, _data(trials, tb.n_max, build_trial_data), conn)
    _assert_histories_match(jres, tres)


@pytest.mark.parametrize("kind", ["dense", "pallas2"])
def test_train_node_view_changes_no_loss(batches, trials, kind):
    _, tb = batches
    model = GNODE(hidden=HIDDEN, max_time=MAX_TIME, adjoint="direct")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    data = _data(trials, tb.n_max, build_trial_data)
    runs = []
    for view in (True, False):
        conn = multigraph_auto_fns(tb, kind=kind, train_node_view=view, device="cpu")
        assert getattr(conn.adj_fn, "n_view", None) == (128 if view else None)
        runs.append(_port_fit(model, params, data, conn))
    for (_, tr_a, va_a), (_, tr_b, va_b) in zip(runs[0].history, runs[1].history):
        assert tr_a == pytest.approx(tr_b, rel=1e-6) and va_a == pytest.approx(va_b, rel=1e-6)
    assert runs[0].test_loss == pytest.approx(runs[1].test_loss, rel=1e-6)


def test_fit_refuses_what_would_train_on_the_wrong_connectivity(graphs, batches, trials):
    _, tb = batches
    model = GNODE(hidden=HIDDEN, max_time=MAX_TIME, adjoint="direct")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    data = _data(trials, tb.n_max, build_trial_data)
    conn = multigraph_auto_fns(tb, kind="pallas2", device="cpu")
    with pytest.raises(ValueError, match="batch_by_graph=True"):
        _port_fit(model, params, data, conn, batch_by_graph=False)
    tr, va, te = multigraph_split(COUNTS)
    opt = lambda leaves: torch.optim.Adam(leaves, lr=LR)
    with pytest.raises(ValueError, match=r"train_idx contains trials of graphs \[2\]"):
        fit(model, opt, params, data, np.concatenate([tr, va]), va, te, epochs=1,
            verbose=False, **conn.fit_kwargs())
    with pytest.raises(ValueError, match="val_idx contains trials of graphs"):
        _port_fit(model, params, data, conn, eval_adj_fn=None)  # the train view reused
    with pytest.raises(ValueError, match="at least 2 graphs"):
        multigraph_auto_fns(pad_graphs(graphs[1][:1]), kind="pallas2", device="cpu")


def test_assemble_multigraph_trials_seeds_and_cache(graphs, tmp_path):
    _, tgs = graphs
    small = tgs[:2]
    per_graph = [[([1, 2], 0.3, 0.1), ([3], 0.4, 0.2)], [([5, 6], 0.2, 0.3)]]
    dirs = [str(tmp_path / g.name) for g in small]
    kw = dict(label_dirs=dirs, sim=60, max_time=4, device="cpu")
    batch, data = assemble_multigraph_trials(small, per_graph, **kw)
    assert data.labels.shape == (3, 4, batch.n_max, 3) and data.graph_idx.tolist() == [0, 0, 1]
    assert data.i0[2, [5, 6]].tolist() == [1, 1] and data.s0[0, 13:].sum() == 0
    np.testing.assert_allclose(data.labels[0, :, :13].sum(-1), 1.0, atol=1e-6)
    assert not data.labels[0, :, 13:].any()  # padding nodes carry no label
    _, again = assemble_multigraph_trials(small, per_graph, **kw)  # a pure cache hit
    assert np.array_equal(again.labels, data.labels)
    _, other = assemble_multigraph_trials(small, per_graph, sim=60, max_time=4, seed=1,
                                          device="cpu")
    _, same = assemble_multigraph_trials(small, per_graph, sim=60, max_time=4, device="cpu")
    assert np.array_equal(same.labels, data.labels)  # seed 0 is the default
    assert not np.array_equal(other.labels, data.labels)
    # two trials with the same parameters on two graphs draw different streams
    twin = [[([1, 2], 0.3, 0.1)], [([1, 2], 0.3, 0.1)]]
    _, d2 = assemble_multigraph_trials([tgs[0], tgs[0]], twin, sim=60, max_time=4, device="cpu")
    assert not np.array_equal(d2.labels[0], d2.labels[1])
