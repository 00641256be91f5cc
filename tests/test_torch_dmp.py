"""Port parity: the DMP baseline (gn_ode_sir_tpu_torch.models.dmp) and
``segment_prod`` against the JAX package on the CPU, 1e-5."""

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.graphs.graph import graph_from_networkx as jax_graph_from_networkx
from gn_ode_sir_tpu.models import DMPSIR as JaxDMPSIR
from gn_ode_sir_tpu.models.dmp import cave_index as jax_cave_index
from gn_ode_sir_tpu.ops.segment import segment_prod as jax_segment_prod
from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.models import DMPSIR, cave_index
from gn_ode_sir_tpu_torch.ops import segment_prod

torch.set_num_threads(1)

ATOL = 1e-5


def _port(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


@pytest.fixture(scope="module")
def tree():
    return jax_graph_from_networkx(nx.balanced_tree(2, 4), name="tree")


def test_segment_prod_with_an_empty_segment():
    rng = np.random.default_rng(0)
    data = rng.uniform(0.5, 1.5, (7, 3)).astype(np.float32)
    ids = np.array([0, 0, 2, 2, 2, 5, 0])  # segments 1, 3, 4 are empty
    got = segment_prod(torch.as_tensor(data), torch.as_tensor(ids), 6)
    want = jax_segment_prod(jnp.asarray(data), jnp.asarray(ids), 6, indices_are_sorted=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert (got[[1, 3, 4]] == 1).all()
    along = segment_prod(torch.as_tensor(data.T.copy()), torch.as_tensor(ids), 6, dim=1)
    torch.testing.assert_close(along, got.T)


@pytest.mark.parametrize("graph", ["karate", "random_graph", "tree"])
def test_cave_index_equals_jax(graph, request):
    jg = request.getfixturevalue(graph)
    got = cave_index(jg.src, jg.dst)
    assert got.dtype == np.int32 and np.array_equal(got, jax_cave_index(jg.src, jg.dst))
    assert np.array_equal(jg.src[got], jg.dst) and np.array_equal(jg.dst[got], jg.src)
    one_way = cave_index(np.array([0, 1]), np.array([1, 2]))  # no reverse edge: the sentinel
    assert one_way.tolist() == [2, 2]
    assert cave_index(np.zeros(0, np.int32), np.zeros(0, np.int32)).shape == (0,)


@pytest.mark.parametrize("graph", ["karate", "tree"])
def test_run_matches_jax(graph, request):
    jg = request.getfixturevalue(graph)
    rng = np.random.default_rng(1)
    jd, td = JaxDMPSIR.from_graph(jg), DMPSIR.from_graph(_port(jg))
    assert np.array_equal(td.cave, jd.cave) and td.n_nodes == jd.n_nodes
    per_edge = rng.uniform(0.1, 0.5, jg.n_edges).astype(np.float32)
    per_node = rng.uniform(0.05, 0.4, jg.n_nodes).astype(np.float32)
    for beta, gamma in ((0.3, 0.2), (per_edge, 0.2), (0.3, per_node), (per_edge, per_node)):
        want = np.asarray(jd.run([0, 5], beta, gamma, max_time=8))
        got = td.run([0, 5], beta, gamma, max_time=8, device="cpu")
        assert got.shape == (8, jg.n_nodes, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=ATOL)
    assert (got[0, [0, 5], 1] == 1).all() and got[0, :, 1].sum() == 2


def test_run_is_exact_on_a_tree(tree):
    """On a tree DMP gives the exact marginals: a leaf's only neighbour is
    its parent, so P(leaf still susceptible at t = 1) = 1 - beta * [parent
    is a seed], and at t = 2 with the parent a seed of recovery rate gamma
    it is (1 - beta) * (1 - beta * (1 - gamma))."""
    beta, gamma = 0.3, 0.25
    g = _port(tree)
    leaf = g.n_nodes - 1
    parent = int(g.src[g.dst == leaf][0])
    m = DMPSIR.from_graph(g).run([parent], beta, gamma, max_time=3, device="cpu")
    assert float(m[1, leaf, 0]) == pytest.approx(1 - beta, abs=1e-6)
    assert float(m[2, leaf, 0]) == pytest.approx((1 - beta) * (1 - beta * (1 - gamma)), abs=1e-6)
    assert float(m[1, parent, 2]) == pytest.approx(gamma, abs=1e-6)


def test_run_many_equals_the_loop_of_run_and_jax(karate):
    jd, td = JaxDMPSIR.from_graph(karate), DMPSIR.from_graph(_port(karate))
    rng = np.random.default_rng(2)
    seeds = [[0, 5], [3], [7, 8, 20], [33]]
    betas, gammas = rng.uniform(0.1, 0.5, 4), rng.uniform(0.05, 0.4, 4)
    got = td.run_many(seeds, betas, gammas, max_time=7, device="cpu")
    assert got.shape == (4, 7, karate.n_nodes, 3)
    for k in range(4):
        one = td.run(seeds[k], float(betas[k]), float(gammas[k]), max_time=7, device="cpu")
        torch.testing.assert_close(got[k], one, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jd.run_many(seeds, betas, gammas, max_time=7)),
                               atol=ATOL)
    per_edge = rng.uniform(0.1, 0.5, (4, karate.n_edges))
    per_node = rng.uniform(0.05, 0.4, (4, karate.n_nodes))
    np.testing.assert_allclose(
        td.run_many(seeds, per_edge, per_node, max_time=5, device="cpu").numpy(),
        np.asarray(jd.run_many(seeds, per_edge, per_node, max_time=5)), atol=ATOL)


@pytest.mark.parametrize("max_time", [1, 2, 3])
def test_short_horizons(karate, max_time):
    jd, td = JaxDMPSIR.from_graph(karate), DMPSIR.from_graph(_port(karate))
    got = td.run([1, 2], 0.4, 0.1, max_time=max_time, device="cpu")
    assert got.shape == (max_time, karate.n_nodes, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jd.run([1, 2], 0.4, 0.1, max_time=max_time)),
                               atol=ATOL)
    many = td.run_many([[1, 2]], [0.4], [0.1], max_time=max_time, device="cpu")
    torch.testing.assert_close(many[0], got, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="max_time"):
        td.run([1], 0.4, 0.1, max_time=0, device="cpu")
