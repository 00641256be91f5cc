"""K3's plain version and the fused no-grad euler forward of ``GNODE.predict``
on the CPU: K3's plain version gives the bits of the field's ops and the
solver's ``_axpy``; ``predict`` without autograd gives the bits of
``_decode`` over the resampled ``_trajectory``; every other call takes the
old path. The kernel itself is held against its plain version on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from gn_ode_sir_tpu_torch.graphs.graph import graph_from_edges
from gn_ode_sir_tpu_torch.models import gnode
from gn_ode_sir_tpu_torch.models.gnode import GNODE, _decode, legacy_dense_gnode
from gn_ode_sir_tpu_torch.odeint import integer_time_indices
from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
from gn_ode_sir_tpu_torch.ops.gnode_step import gnode_step
from gn_ode_sir_tpu_torch.ops.spmm2 import spmm2

torch.set_num_threads(1)


def _karate():
    import networkx as nx

    return graph_from_edges(34, list(nx.karate_club_graph().edges()), name="karate")


def _random_graph(n=120, m=600, seed=4):
    """A seeded random graph with a hub of 90 edges (cut into two of K1's
    work items) and isolated nodes."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n - 5, size=(m, 2))
    hub = np.stack([np.zeros(90, np.int64), rng.integers(1, n - 5, 90)], axis=1)
    return graph_from_edges(n, np.concatenate([pairs, hub]), name="rand")


def _inputs(n, batch, seed=0):
    rng = np.random.default_rng(seed)
    i0 = np.zeros((batch, n), np.float32)
    for j in range(batch):
        i0[j, rng.choice(n, 2, replace=False)] = 1.0
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return (as_t(1.0 - i0), as_t(i0), as_t(np.zeros_like(i0)),
            as_t(rng.uniform(0.1, 0.5, batch)), as_t(rng.uniform(0.1, 0.5, batch)))


def _old_path(model, params, adj, xs):
    """``predict`` as it was: the dense trajectory, resampled, decoded."""
    traj = model._trajectory(params, adj, *xs)
    idx = torch.as_tensor(integer_time_indices(model.max_time, model.delta_t), dtype=torch.long)
    return _decode(params, tuple(c[idx] for c in traj))


@pytest.fixture
def k3_calls(monkeypatch):
    """Counts the fused forward's calls of K3 (through ``models.gnode``)."""
    calls = []

    def recording(*args, **kwargs):
        calls.append(kwargs.get("out") is not None)
        return gnode_step(*args, **kwargs)

    monkeypatch.setattr(gnode, "gnode_step", recording)
    return calls


@pytest.mark.parametrize("batch,h", [(1, 8), (3, 5), (3, 64)])
def test_plain_step_gives_the_bits_of_the_field_ops_and_axpy(batch, h):
    g = torch.Generator().manual_seed(batch * 100 + h)
    rand = lambda *s: torch.rand(*s, generator=g)
    ai, zs, zi = (rand(batch, 40, h) * 30 for _ in range(3))
    state = torch.randn(3, batch, 40, h, generator=g)
    beta, gamma = rand(batch), rand(batch)
    dt = np.float32(0.5)
    # the field's ops and the solver's _axpy as they are written there
    b, gm = beta[:, None, None], gamma[:, None, None]
    ds = -b * ai * zs
    di = -ds - gm * zi
    dr = gm * zi
    ha = torch.tensor(float(dt), dtype=torch.float32).item()
    want = [y + ha * d for y, d in zip(state, (ds, di, dr))]
    out = torch.full((batch, 40, 3, h), np.nan)
    launches = gnode_step.launches
    gnode_step(ai, zs, zi, state, beta, gamma, dt, out=out)
    assert gnode_step.launches == launches  # CPU calls are not counted
    for c in range(3):
        assert torch.equal(state[c], want[c])
        assert torch.equal(out[:, :, c], want[c])


def test_step_refuses_shapes_that_do_not_fit():
    x = torch.zeros(2, 5, 4)
    state, rates = torch.zeros(3, 2, 5, 4), torch.zeros(2)
    with pytest.raises(ValueError, match="state"):
        gnode_step(x, x, x, state[:2], rates, rates, 0.5)
    with pytest.raises(ValueError, match="out"):
        gnode_step(x, x, x, state, rates, rates, 0.5, out=torch.zeros(2, 5, 4, 3))
    with pytest.raises(ValueError, match="beta"):
        gnode_step(x, x, x, state, torch.zeros(3), rates, 0.5)


@pytest.mark.parametrize("graph,kind,batch", [
    ("karate", "dense", 2), ("random", "pallas2", 1), ("random", "pallas2", 3)])
@pytest.mark.parametrize("activation", ["sigmoid", "relu"])
def test_fused_predict_gives_the_bits_of_the_old_path(graph, kind, batch, activation,
                                                      k3_calls):
    g = _karate() if graph == "karate" else _random_graph()
    model = GNODE(hidden=16, activation=activation)
    params = model.init(torch.Generator().manual_seed(batch), device="cpu")
    if activation == "relu":  # an unbounded field: keep its euler trajectory finite
        params["func"]["w"] *= 0.1
    adj = adjacency_from_graph(g, kind=kind, device="cpu")
    xs = _inputs(g.n_nodes, batch)
    launches = (spmm2.launches, gnode_step.launches)
    with torch.inference_mode():
        got = model.predict(params, adj, *xs)
        assert len(k3_calls) == len(model.ts) - 1  # one K3 a field evaluation
        assert sum(k3_calls) == model.max_time - 1  # the label times after t = 0
        want = _old_path(model, params, adj, xs)
    assert got.shape == (model.max_time, batch, g.n_nodes, 3)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)
    # on the CPU neither kernel launches, and neither counts
    assert (spmm2.launches, gnode_step.launches) == launches


def test_fused_predict_with_trained_leaves_and_a_coarse_grid(k3_calls):
    """An evaluation pass: leaves that require grad, under ``no_grad``; a
    grid of Δt 2, so that one grid index gives two label times; no
    encoded R."""
    g = _random_graph()
    model = GNODE(hidden=8, delta_t=2.0, encode_r=False)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    for leaves in params.values():
        for leaf in leaves.values():
            leaf.requires_grad_(True)
    adj = adjacency_from_graph(g, kind="pallas2", device="cpu")
    xs = _inputs(g.n_nodes, 2, seed=1)
    with torch.no_grad():
        got = model.predict(params, adj, *xs)
        assert len(k3_calls) == len(model.ts) - 1
        want = _old_path(model, params, adj, xs)
    assert torch.equal(got, want)


def _members(model, k):
    ps = [model.init(torch.Generator().manual_seed(j), device="cpu") for j in range(k)]
    return {name: {leaf: torch.stack([p[name][leaf] for p in ps]) for leaf in ps[0][name]}
            for name in ps[0]}


@pytest.mark.parametrize("case", ["grad", "bf16", "rk4", "deriv_layernorm", "legacy", "vmap"])
def test_every_other_call_takes_the_old_path(case, k3_calls):
    g = _random_graph()
    model = {"bf16": GNODE(hidden=8, compute_dtype="bf16"), "rk4": GNODE(hidden=8, method="rk4"),
             "deriv_layernorm": GNODE(hidden=8, deriv_layernorm=True),
             "legacy": legacy_dense_gnode(hidden=8)}.get(case, GNODE(hidden=8))
    adj = adjacency_from_graph(g, kind="dense", device="cpu")
    xs = _inputs(g.n_nodes, 2, seed=2)
    if case == "vmap":
        stacked = _members(model, 3)
        with torch.no_grad():
            got = torch.func.vmap(lambda p: model.predict(p, adj, *xs))(stacked)
            want = torch.stack([
                _old_path(model, {n: {leaf: t[j] for leaf, t in v.items()}
                                  for n, v in stacked.items()}, adj, xs) for j in range(3)])
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    else:
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        with torch.set_grad_enabled(case == "grad"):
            got = model.predict(params, adj, *xs)
            want = _old_path(model, params, adj, xs)
        assert torch.equal(got, want)
    assert k3_calls == []
