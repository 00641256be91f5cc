"""Port parity: multi-graph batching and the adjacency pieces that serve it
(gn_ode_sir_tpu_torch.graphs.batch, graphs.load.load_graphs, per-sample
CooAdj, [B, n, n] DenseAdj, gcn_norm_edges, _normalized_edges) against the
JAX package on the same graphs, on the CPU."""

import pickle

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.graphs import batch_index_graphs as jax_batch_index_graphs
from gn_ode_sir_tpu.graphs import load_graphs as jax_load_graphs
from gn_ode_sir_tpu.graphs import pad_graphs as jax_pad_graphs
from gn_ode_sir_tpu.graphs.graph import graph_from_edges as jax_graph_from_edges
from gn_ode_sir_tpu.ops import gcn_norm_edges as jax_gcn_norm_edges
from gn_ode_sir_tpu.ops.adjacency import DenseAdj as JaxDenseAdj
from gn_ode_sir_tpu.ops.adjacency import adjacency_from_batch as jax_adjacency_from_batch
from gn_ode_sir_tpu.train.multigraph import _normalized_edges as jax_normalized_edges
from gn_ode_sir_tpu_torch.graphs import (GraphBatch, batch_index_graphs, graph_from_edges,
                                         load_graphs, pad_graphs)
from gn_ode_sir_tpu_torch.ops import gcn_norm_edges, spmm_coo
from gn_ode_sir_tpu_torch.ops.adjacency import DenseAdj, adjacency_from_batch
from gn_ode_sir_tpu_torch.train.multigraph import _normalized_edges

torch.set_num_threads(1)

SIZES = ((13, 20), (30, 70), (22, 35))  # uneven (nodes, undirected edges): padding is real
FIELDS = ("src", "dst", "edge_w", "node_mask", "n_nodes", "n_edges")


def _edges(n, m, seed, loops=0):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n, (m, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return np.concatenate([pairs, np.repeat(rng.choice(n, loops, replace=False), 2)
                           .reshape(-1, 2)])


@pytest.fixture(scope="module")
def graph_pairs():
    """The same three graphs in both packages; the second carries self-loops."""
    out = []
    for k, (n, m) in enumerate(SIZES):
        e = _edges(n, m, k, loops=3 if k == 1 else 0)
        out.append((jax_graph_from_edges(n, e, name=f"g{k}"), graph_from_edges(n, e, name=f"g{k}")))
    return [p[0] for p in out], [p[1] for p in out]


@pytest.mark.parametrize("multiples", [(8, 128), (8, 16), (1, 1)])
def test_pad_graphs_equals_jax_bit_for_bit(graph_pairs, multiples):
    jgs, tgs = graph_pairs
    jb, tb = jax_pad_graphs(jgs, *multiples), pad_graphs(tgs, *multiples)
    assert isinstance(tb, GraphBatch) and tb.names == jb.names == ("g0", "g1", "g2")
    assert (tb.num_graphs, tb.n_max, tb.e_max) == (jb.num_graphs, jb.n_max, jb.e_max)
    for f in FIELDS:
        a, b = getattr(jb, f), getattr(tb, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (np.diff(tb.dst, axis=1) >= 0).all()  # padded rows stay dst-sorted
    assert tb.n_max > max(n for n, _ in SIZES) - 8 and (tb.edge_w.sum(1) == tb.n_edges).all()
    gi = np.array([2, 0, 2, 1])
    for a, b in zip(jax_batch_index_graphs(jb, gi), batch_index_graphs(tb, gi)):
        assert np.array_equal(a, b)


def test_load_graphs_reads_a_plus_joined_dataset(tmp_path):
    for name, G in (("ring", nx.cycle_graph(9)), ("wheel", nx.wheel_graph(7))):
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump(G, f)
    for got in (load_graphs(str(tmp_path / "ring+wheel")),
                load_graphs("ring+wheel", root=str(tmp_path))):
        want = jax_load_graphs(str(tmp_path / "ring+wheel"))
        assert [g.name for g in got] == ["ring", "wheel"]
        for a, b in zip(want, got):
            assert a.n_nodes == b.n_nodes
            assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)


def test_per_sample_coo_matvec_matches_jax_and_each_graph(graph_pairs):
    jgs, tgs = graph_pairs
    jb, tb = jax_pad_graphs(jgs, 8, 16), pad_graphs(tgs, 8, 16)
    gi = np.array([0, 1, 2, 1])
    x = np.random.default_rng(0).standard_normal((4, tb.n_max, 5)).astype(np.float32)
    tadj = adjacency_from_batch(tb, gi, device="cpu")
    assert tadj.src.shape == (4, tb.e_max) and tadj.n_nodes == tb.n_max
    got = tadj.matvec(torch.as_tensor(x)).numpy()
    want = np.asarray(jax_adjacency_from_batch(jb, gi).matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    for b, g_i in enumerate(gi):  # each sample is its own graph's SpMM; padding adds nothing
        g = tgs[g_i]
        one = spmm_coo(torch.as_tensor(g.src).long(), torch.as_tensor(g.dst).long(),
                       torch.as_tensor(x[b, :g.n_nodes]), g.n_nodes).numpy()
        np.testing.assert_allclose(got[b, :g.n_nodes], one, atol=1e-6)
        assert not got[b, g.n_nodes:].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_adj_with_a_per_sample_stack_matches_jax(graph_pairs, dtype):
    _, tgs = graph_pairs
    tb = pad_graphs(tgs, 8, 16)
    stack = np.zeros((3, tb.n_max, tb.n_max), np.float32)
    for g in range(3):
        np.add.at(stack[g], (tb.dst[g], tb.src[g]), tb.edge_w[g])
    gi = np.array([1, 1, 0, 2])
    x = np.random.default_rng(1).standard_normal((4, tb.n_max, 6)).astype(np.float32)
    tt, jt = ((torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16))
    got = DenseAdj(torch.as_tensor(stack[gi]).to(tt)).matvec(torch.as_tensor(x))
    want = JaxDenseAdj(jnp.asarray(stack[gi], jt)).matvec(jnp.asarray(x))
    assert got.dtype == torch.float32 and got.shape == (4, tb.n_max, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6 if dtype == "f32" else 1e-5)


def test_gcn_norm_edges_matches_jax_on_a_graph_with_self_loops(graph_pairs):
    jgs, tgs = graph_pairs
    assert (tgs[1].src == tgs[1].dst).sum() == 3
    for jg, tg in zip(jgs, tgs):
        for loops in (True, False):
            want, got = jax_gcn_norm_edges(jg, loops), gcn_norm_edges(tg, loops)
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            np.testing.assert_allclose(got[2], want[2], atol=1e-7)
    src, dst, w = gcn_norm_edges(tgs[1])
    assert (src == dst).sum() == tgs[1].n_nodes  # one loop per node, none doubled
    assert src.size == tgs[1].n_edges - 3 + tgs[1].n_nodes and (np.diff(dst) >= 0).all()


def test_normalized_edges_matches_jax_and_the_single_graph_weights(graph_pairs):
    jgs, tgs = graph_pairs
    jb, tb = jax_pad_graphs(jgs, 8, 16), pad_graphs(tgs, 8, 16)
    want, got = jax_normalized_edges(jb), _normalized_edges(tb)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-7)
    for g_i, g in enumerate(tgs):
        src, dst, w = gcn_norm_edges(g)
        m = src.size
        assert np.array_equal(got[0][g_i, :m], src) and np.array_equal(got[1][g_i, :m], dst)
        np.testing.assert_allclose(got[2][g_i, :m], w, atol=1e-7)
        assert not got[2][g_i, m:].any() and (np.diff(got[1][g_i]) >= 0).all()
