"""Port parity: ``gn_ode_sir_tpu_torch.ops.ell`` against ``gn_ode_sir_tpu.ops.ell``
on karate, gnp50 and a 620-node power-law graph.

The bucket matrices and offsets are host integers: equal. ``EllAdj.matvec``
sums at most 2^k float32 neighbours per row in the same order as the JAX
gather-sum, within 1e-5 (rounding of the sum order inside XLA's reduce); its
gradient matches ``jax.vjp`` within 1e-5. The worker runs ``--spmm ell``.
"""

import io
import contextlib

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.graphs.graph import graph_from_networkx as jax_graph_from_networkx
from gn_ode_sir_tpu.ops import ell as jax_ell
from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.ops import EllAdj, build_ell_buckets, row_offsets_from_sorted_dst
from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph

torch.set_num_threads(1)

ATOL = 1e-5


def _port(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


@pytest.fixture(params=["karate", "gnp50", "pl620"])
def jgraph(request, karate, random_graph):
    if request.param == "pl620":
        return jax_graph_from_networkx(nx.barabasi_albert_graph(620, 3, seed=4), name="pl620")
    return {"karate": karate, "gnp50": random_graph}[request.param]


def test_row_offsets_equal_jax(jgraph):
    got = row_offsets_from_sorted_dst(jgraph.dst, jgraph.n_nodes)
    want = jax_ell.row_offsets_from_sorted_dst(jgraph.dst, jgraph.n_nodes)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_buckets", [10, 3])
def test_buckets_equal_jax(jgraph, max_buckets):
    got, inv = build_ell_buckets(_port(jgraph), max_buckets)
    want, jinv = jax_ell.build_ell_buckets(jgraph, max_buckets)
    assert len(got) == len(want) <= max_buckets
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(inv, jinv)


def test_matvec_and_gradient_equal_jax(jgraph):
    rng = np.random.default_rng(jgraph.n_nodes)
    x = rng.standard_normal((3, jgraph.n_nodes, 4)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jadj = jax_ell.EllAdj.from_graph(jgraph)
    want, vjp = jax.vjp(jadj.matvec, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    adj = adjacency_from_graph(_port(jgraph), kind="ell", device="cpu")
    assert isinstance(adj, EllAdj)
    xt = torch.as_tensor(x).requires_grad_(True)
    got = adj.matvec(xt)
    (dx,) = torch.autograd.grad(got, xt, torch.as_tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=ATOL, rtol=0)
    # and A·x of the dense adjacency
    dense = torch.as_tensor(jgraph.dense_adjacency) @ torch.as_tensor(x)
    np.testing.assert_allclose(got.detach().numpy(), dense.numpy(), atol=ATOL, rtol=0)


def test_worker_runs_spmm_ell(tmp_path):
    from gn_ode_sir_tpu_torch.cli import worker
    from gn_ode_sir_tpu_torch.graphs import graph_from_networkx

    g = graph_from_networkx(nx.karate_club_graph(), name="karate")
    argv = ["--device", "cpu", "--dataset", "karate", "--epochs", "2", "--hidden", "4",
            "--maxTime", "4", "--sim", "50", "--batch_size", "2", "--lr", "1e-2",
            "--spmm", "ell", "--I_indices", "[1]", "[2]", "[3]", "[4]", "[5]",
            "--beta", "0.2", "0.3", "0.4", "0.25", "0.35",
            "--gamma", "0.1", "0.2", "0.3", "0.15", "0.25", "--path_to_save", str(tmp_path)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert worker.main(argv, graph=g) == 0
    assert "Epoch: 001" in out.getvalue()
    assert (tmp_path / "Metrics-trials-karate").exists()
