"""Port parity: the classical mean-field SIR baseline
(gn_ode_sir_tpu_torch.sim.classical) against the JAX package on the CPU:
the same graph, seed sets and rates through both integrators, 1e-5."""

import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.sim import classical as jax_classical
from gn_ode_sir_tpu_torch.graphs.graph import Graph, graph_from_edges
from gn_ode_sir_tpu_torch.sim import classical, sir_classical, sir_classical_batch, sir_field

torch.set_num_threads(1)

ATOL = 1e-5
SEEDS, BETAS, GAMMAS = [[0, 5], [7], [3, 9, 20]], [0.3, 0.45, 0.15], [0.2, 0.05, 0.3]


def _port(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


@pytest.mark.parametrize("graph", ["karate", "random_graph"])
def test_auto_substeps_equals_jax(graph, request):
    jg = request.getfixturevalue(graph)
    for betas, gmax, dt in (([0.3], 0.2, 0.5), ([0.49, 0.1], 0.5, 0.5), ([0.05], 0.01, 0.25),
                            ([0.9], 0.9, 1.0)):
        assert (classical.auto_substeps(_port(jg), betas, gmax, dt)
                == jax_classical.auto_substeps(jg, betas, gmax, dt))
    star = graph_from_edges(1501, [(0, k) for k in range(1, 1501)])
    assert classical.auto_substeps(star, [0.49], 0.3, 0.5) == 256  # a hub forces refinement


@pytest.mark.parametrize("method", ["rk4", "euler"])
@pytest.mark.parametrize("substeps", [1, 4, None])
def test_batch_matches_jax(karate, method, substeps):
    kw = dict(max_time=6, method=method, substeps=substeps)
    want = jax_classical.sir_classical_batch(karate, SEEDS, BETAS, GAMMAS, **kw)
    got = sir_classical_batch(_port(karate), SEEDS, BETAS, GAMMAS, device="cpu", **kw)
    for w, g in zip(want, got):  # (I, S, R), each [B, max_time, n]
        assert g.shape == (3, 6, karate.n_nodes) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)
    i, s, r = got
    np.testing.assert_allclose(s + i + r, 1.0, atol=ATOL)
    assert (i[0, 0, [0, 5]] == 1).all() and i[0, 0].sum() == 2 and not r[:, 0].any()
    assert (np.diff(r, axis=1) >= -1e-7).all()


@pytest.mark.parametrize("delta_t", [0.5, 0.25])
def test_single_trial_matches_jax_and_its_batch_row(random_graph, delta_t):
    kw = dict(max_time=5, delta_t=delta_t)
    want = jax_classical.sir_classical(random_graph, [4, 11], 0.35, 0.1, **kw)
    got = sir_classical(_port(random_graph), [4, 11], 0.35, 0.1, device="cpu", **kw)
    batch = sir_classical_batch(_port(random_graph), [[1], [4, 11]], [0.2, 0.35], [0.3, 0.1],
                                device="cpu", **kw)
    for w, g, b in zip(want, got, batch):
        assert g.shape == (5, random_graph.n_nodes)
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)
        np.testing.assert_allclose(g, b[1], atol=1e-6)


def test_bf16_branch_tracks_f32_and_jax(karate, monkeypatch):
    """No shipped graph crosses the node threshold: lower it, on both sides."""
    g = _port(karate)
    i_f, s_f, r_f = sir_classical(g, [0, 5], 0.3, 0.2, max_time=10, device="cpu")
    monkeypatch.setattr(classical, "_BF16_NODE_THRESHOLD", 1)
    monkeypatch.setattr(jax_classical, "_BF16_NODE_THRESHOLD", 1)
    i_b, s_b, r_b = sir_classical(g, [0, 5], 0.3, 0.2, max_time=10, device="cpu")
    assert np.isfinite(i_b).all() and not np.array_equal(i_b, i_f)
    assert np.abs(i_b - i_f).max() < 3e-2 and np.abs(s_b + i_b + r_b - 1).max() < 5e-2
    i_j, s_j, r_j = jax_classical.sir_classical(karate, [0, 5], 0.3, 0.2, max_time=10)
    # both round I to bf16 before the product; a rounding boundary may fall
    # differently once the states differ in the last bit
    assert np.abs(i_b - np.asarray(i_j)).max() < 2e-3


def test_sir_field_and_scipy_engine(karate):
    g = _port(karate)
    a = torch.as_tensor(g.dense_adjacency)
    i0 = torch.zeros(g.n_nodes)
    i0[[0, 5]] = 1.0
    ds, di, dr = sir_field(0.0, (1 - i0, i0, torch.zeros_like(i0)), (a, 0.3, 0.2))
    torch.testing.assert_close(ds + di + dr, torch.zeros_like(ds), atol=1e-7, rtol=0)
    assert dr[0] == pytest.approx(0.2) and ds[0] == 0 and ds[1] < 0
    fine = sir_classical(g, [0, 5], 0.3, 0.2, max_time=8, substeps=8, device="cpu")
    lsoda = sir_classical(g, [0, 5], 0.3, 0.2, max_time=8, engine="scipy", device="cpu")
    for x, y in zip(fine, lsoda):
        np.testing.assert_allclose(x, y, atol=1e-4)
