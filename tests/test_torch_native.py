"""Port parity: ``gn_ode_sir_tpu_torch.native`` (the port's own build of
graphcore.cc) against the JAX package's ``native`` and against the numpy
fallback (``GN_ODE_SIR_NO_NATIVE``). Host integer code: every array must be
equal, element for element.
"""

import os

import networkx as nx
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu import native as jax_native
from gn_ode_sir_tpu_torch import native
from gn_ode_sir_tpu_torch.graphs import graph_from_networkx

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def libraries():
    if not (native.native_available() and jax_native.native_available()):
        pytest.fail("the native graph core did not build (g++ -O3 -shared -fPIC)")


def _raw_pairs(seed=0, m=500, n=80):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n, (m, 2), dtype=np.int32)
    # duplicates, both orientations and self-loops
    pairs = np.concatenate([pairs, pairs[:50], pairs[:30, ::-1],
                            np.stack([np.arange(5), np.arange(5)], 1).astype(np.int32)])
    return pairs, n


def _powerlaw620():
    G = nx.barabasi_albert_graph(620, 3, seed=4)
    return graph_from_networkx(G, name="pl620")


@pytest.fixture(params=["karate", "gnp50", "pl620"])
def graph(request, karate, random_graph):
    return {"karate": karate, "gnp50": random_graph, "pl620": _powerlaw620()}[request.param]


def test_library_lands_in_the_build_directory():
    path = native.library_path()
    assert path.parent.name == "_build" and path.parent.parent.name == "gn_ode_sir_tpu_torch"
    assert path.exists()
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(native.__file__)))


def test_coalesce_undirected_equals_jax_and_fallback(monkeypatch):
    from gn_ode_sir_tpu_torch.graphs import graph_from_edges

    pairs, n = _raw_pairs()
    src, dst = native.coalesce_undirected(pairs, n)
    jsrc, jdst = jax_native.coalesce_undirected(pairs, n)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    g = graph_from_edges(n, pairs)
    monkeypatch.setenv("GN_ODE_SIR_NO_NATIVE", "1")
    assert native.coalesce_undirected(pairs, n) is None
    fallback = graph_from_edges(n, pairs)
    np.testing.assert_array_equal(g.src, fallback.src)
    np.testing.assert_array_equal(g.dst, fallback.dst)
    np.testing.assert_array_equal(src, fallback.src)


def test_csr_offsets_equals_jax_and_fallback(graph):
    from gn_ode_sir_tpu_torch.ops import row_offsets_from_sorted_dst

    got = native.csr_offsets(graph.dst, graph.n_nodes)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_native.csr_offsets(graph.dst, graph.n_nodes))
    np.testing.assert_array_equal(got, row_offsets_from_sorted_dst(graph.dst, graph.n_nodes))
    # refused (None -> the caller's numpy path) for an unsorted list
    assert native.csr_offsets(graph.dst[::-1], graph.n_nodes) is None


def test_csr_plan_equal_with_and_without_native(graph, monkeypatch):
    """K1's plan builds its row pointer with numpy (the library is no faster
    there): its row pointer equals the library's offsets, and the plan does
    not depend on the switch."""
    from gn_ode_sir_tpu_torch.ops.spmm2 import CsrPlan

    w = np.random.default_rng(2).random(graph.n_edges).astype(np.float32)
    a = CsrPlan.build(graph.src, graph.dst, graph.n_nodes, w=w, device="cpu")
    np.testing.assert_array_equal(a.row_ptr.numpy(), native.csr_offsets(graph.dst, graph.n_nodes))
    monkeypatch.setenv("GN_ODE_SIR_NO_NATIVE", "1")
    b = CsrPlan.build(graph.src, graph.dst, graph.n_nodes, w=w, device="cpu")
    for field in ("row_ptr", "src", "dst", "w", "edge_item", "item_row", "work", "fix_row",
                  "fix_ptr"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_reverse_edge_index_equals_jax_and_fallback(graph, monkeypatch):
    from gn_ode_sir_tpu_torch.models.dmp import cave_index

    got = native.reverse_edge_index(graph.src, graph.dst, graph.n_nodes)
    np.testing.assert_array_equal(
        got, jax_native.reverse_edge_index(graph.src, graph.dst, graph.n_nodes))
    # DMP's cave_index is the numpy path (the library is slower there)
    np.testing.assert_array_equal(cave_index(graph.src, graph.dst), got)
    monkeypatch.setenv("GN_ODE_SIR_NO_NATIVE", "1")
    assert native.reverse_edge_index(graph.src, graph.dst, graph.n_nodes) is None
    # the sentinel E where the reverse edge is missing
    np.testing.assert_array_equal(cave_index(np.array([0, 2]), np.array([1, 1])), [2, 2])


def test_degrees_equals_jax_and_fallback(graph):
    got = native.degrees(graph.dst, graph.n_nodes)
    np.testing.assert_array_equal(got, jax_native.degrees(graph.dst, graph.n_nodes))
    np.testing.assert_array_equal(got, np.bincount(graph.dst, minlength=graph.n_nodes))


@pytest.mark.parametrize("weighted", [True, False])
def test_spmm_plan_equals_jax_and_fallback(graph, weighted, monkeypatch):
    from gn_ode_sir_tpu.ops.pallas_spmm2 import SpmmPlan

    w = np.random.default_rng(9).random(graph.n_edges).astype(np.float32) if weighted else None
    got = native.spmm_plan(graph.src, graph.dst, w, 32, 8)
    want = jax_native.spmm_plan(graph.src, graph.dst, w, 32, 8)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("GN_ODE_SIR_NO_NATIVE", "1")
    assert native.spmm_plan(graph.src, graph.dst, w, 32, 8) is None
    py = SpmmPlan.build(graph.src, graph.dst, graph.n_nodes, w=w, k_edges=32, r_rows=8)
    np.testing.assert_array_equal(got[0], py.src_padded)
    np.testing.assert_array_equal(got[1], py.dst_local[:, 0])  # JAX replicates 8 sublanes
    np.testing.assert_array_equal(got[2], py.row_base)
    if weighted:
        np.testing.assert_array_equal(got[3], py.w_padded)
