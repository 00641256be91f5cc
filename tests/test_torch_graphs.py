"""Port parity: gn_ode_sir_tpu_torch.graphs against gn_ode_sir_tpu.graphs.

The same networkx graphs go through both packages; every array the
adjacency backends build from must be equal.
"""

import networkx as nx
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.graphs import load_graph as jax_load_graph
from gn_ode_sir_tpu.graphs.graph import graph_from_edges as jax_graph_from_edges
from gn_ode_sir_tpu_torch.graphs import Graph, graph_from_edges, graph_from_networkx, load_graph

torch.set_num_threads(1)


def _gnp50():
    # the conftest ``random_graph`` recipe
    G = nx.fast_gnp_random_graph(50, 0.12, seed=3)
    return G.subgraph(max(nx.connected_components(G), key=len))


@pytest.fixture(params=["karate", "gnp50"])
def graph_pair(request, karate, random_graph):
    """(JAX Graph from the conftest fixture, port Graph from the same networkx graph)."""
    if request.param == "karate":
        return karate, graph_from_networkx(nx.karate_club_graph(), name="karate")
    return random_graph, graph_from_networkx(_gnp50(), name="gnp50")


@pytest.mark.parametrize("field", ["src", "dst", "degrees", "dense_adjacency"])
def test_graph_arrays_equal_jax(graph_pair, field):
    jg, tg = graph_pair
    assert tg.n_nodes == jg.n_nodes and tg.n_edges == jg.n_edges
    a, b = getattr(jg, field), getattr(tg, field)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_pad", [None, 64])
def test_padded_edges_equal_jax(graph_pair, n_pad):
    jg, tg = graph_pair
    e_max = jg.n_edges + 37
    for a, b in zip(jg.padded_edges(e_max, n_pad), tg.padded_edges(e_max, n_pad)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tg.padded_edges(tg.n_edges - 1)


def test_dst_sorted_and_symmetric(graph_pair):
    _, tg = graph_pair
    assert np.all(np.diff(tg.dst) >= 0)
    a = tg.dense_adjacency
    np.testing.assert_array_equal(a, a.T)


def test_graph_from_edges_dedup_loops_and_array_input():
    """Duplicates collapse, a self-loop stays one directed edge, and an
    [m, 2] array builds the same graph as a list of pairs (JAX numpy path)."""
    edges = [(0, 1), (1, 0), (2, 2), (3, 1), (1, 3), (4, 0)]
    jg = jax_graph_from_edges(5, edges)
    for tg in (graph_from_edges(5, edges), graph_from_edges(5, np.asarray(edges))):
        np.testing.assert_array_equal(tg.src, jg.src)
        np.testing.assert_array_equal(tg.dst, jg.dst)
    assert graph_from_edges(5, []).n_edges == 0


@pytest.mark.parametrize("bad", [[(0, 5)], [(-1, 2)]])
def test_graph_from_edges_rejects_out_of_range(bad):
    with pytest.raises(ValueError, match="outside"):
        graph_from_edges(5, bad)


def test_graph_rejects_mismatched_arrays():
    with pytest.raises(ValueError):
        Graph(n_nodes=3, src=np.zeros(2), dst=np.zeros(3))


@pytest.mark.parametrize("seed", [0, 4])
def test_load_graph_none_equal_jax(seed):
    jg, tg = jax_load_graph("none", seed=seed), load_graph("none", seed=seed)
    assert tg.name == jg.name == "gnp50"
    np.testing.assert_array_equal(tg.src, jg.src)
    np.testing.assert_array_equal(tg.dst, jg.dst)


def test_load_graph_pickle_largest_component(tmp_path):
    """A pickled networkx graph loads undirected, restricted to its largest
    connected component, exactly as the JAX loader does."""
    import pickle

    G = nx.DiGraph([(0, 1), (1, 2), (2, 0), (5, 6)])
    path = tmp_path / "toy.pkl"
    with open(path, "wb") as f:
        pickle.dump(G, f)
    jg, tg = jax_load_graph(str(tmp_path / "toy")), load_graph(str(path))
    assert tg.name == jg.name == "toy"
    assert tg.n_nodes == jg.n_nodes == 3
    np.testing.assert_array_equal(tg.src, jg.src)
    np.testing.assert_array_equal(tg.dst, jg.dst)
