"""Port parity: the backsolve adjoint (``gn_ode_sir_tpu_torch.odeint.adjoint``)
against the JAX package's ``odeint_grid_backsolve`` and against the port's
own ``direct`` adjoint.

Both packages run the same algorithm in float32, so trajectories agree to
1e-6 relative and gradients to 1e-5 relative. Against plain autograd
(``direct``) the backsolve gradient carries the reverse integration's error:
2e-3 relative, the JAX package's own tolerance (``tests/test_odeint.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.models.gnode import GNODE as JaxGNODE
from gn_ode_sir_tpu.odeint import odeint_grid_backsolve as jax_backsolve
from gn_ode_sir_tpu.ops.adjacency import adjacency_from_graph as jax_adjacency
from gn_ode_sir_tpu.train.loss import l1_sir_loss as jax_l1
from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.models.gnode import GNODE
from gn_ode_sir_tpu_torch.odeint import odeint_grid, odeint_grid_backsolve
from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
from gn_ode_sir_tpu_torch.train.checkpoint import params_from_numpy, tree_leaves
from gn_ode_sir_tpu_torch.train.loss import l1_sir_loss

torch.set_num_threads(1)

RTOL_SAME = 1e-5  # the same algorithm in both packages
RTOL_DIRECT = 2e-3  # backsolve against plain autograd


def _jax_field(t, y, args):
    a, m = args
    return tuple(-a * v + jnp.tanh(m @ v) for v in y)


def _torch_field(t, y, args):
    a, m = args
    return tuple(-a * v + torch.tanh(m @ v) for v in y)


def _problem():
    rng = np.random.default_rng(0)
    m = (0.3 * rng.standard_normal((3, 3))).astype(np.float32)
    y0 = (rng.standard_normal(3).astype(np.float32), rng.standard_normal(3).astype(np.float32))
    return np.float32(0.7), m, y0


@pytest.mark.parametrize("method", ["euler", "rk4", "midpoint"])
def test_backsolve_matches_jax(method):
    a, m, y0 = _problem()
    ts = np.linspace(0.0, 2.0, 21, dtype=np.float32)

    def jloss(a_, m_, y0_):
        ys = jax_backsolve(_jax_field, y0_, ts, (a_, m_), method=method)
        return sum(jnp.sum(jnp.sin(v)) for v in ys)

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(m), tuple(jnp.asarray(v) for v in y0))

    at = torch.tensor(a, requires_grad=True)
    mt = torch.tensor(m, requires_grad=True)
    yt = tuple(torch.tensor(v, requires_grad=True) for v in y0)
    ys = odeint_grid_backsolve(_torch_field, yt, ts, (at, mt), method=method)
    assert [tuple(v.shape) for v in ys] == [(21, 3), (21, 3)]
    loss = sum(torch.sin(v).sum() for v in ys)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=RTOL_SAME)
    np.testing.assert_allclose(float(at.grad), float(jgrads[0]), rtol=RTOL_SAME)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(jgrads[1]), rtol=RTOL_SAME, atol=1e-7)
    for got, want in zip(yt, jgrads[2]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=RTOL_SAME, atol=1e-7)


def test_backsolve_close_to_direct_and_equal_without_gradients():
    a, m, y0 = _problem()
    ts = np.linspace(0.0, 1.0, 41, dtype=np.float32)
    results = {}
    for adjoint in ("direct", "backsolve"):
        at = torch.tensor(a, requires_grad=True)
        mt = torch.tensor(m, requires_grad=True)
        ys = odeint_grid(_torch_field, tuple(torch.tensor(v) for v in y0), ts, (at, mt),
                         method="rk4", adjoint=adjoint)
        loss = sum((v ** 2).sum() for v in ys)
        loss.backward()
        results[adjoint] = (loss.item(), float(at.grad), mt.grad.clone())
    assert results["backsolve"][0] == pytest.approx(results["direct"][0], rel=1e-6)
    assert results["backsolve"][1] == pytest.approx(results["direct"][1], rel=RTOL_DIRECT)
    np.testing.assert_allclose(results["backsolve"][2], results["direct"][2],
                               rtol=RTOL_DIRECT, atol=1e-6)
    # without gradients the integration is the direct adjoint's, exactly
    with torch.no_grad():
        args = (torch.tensor(a), torch.tensor(m))
        y = tuple(torch.tensor(v) for v in y0)
        for got, want in zip(odeint_grid(_torch_field, y, ts, args, method="rk4",
                                         adjoint="backsolve"),
                             odeint_grid(_torch_field, y, ts, args, method="rk4",
                                         adjoint="direct")):
            assert torch.equal(got, want)


def test_diff_mask_and_integer_leaves_are_not_carried():
    """An excluded subtree and an integer tensor get no gradient and do not
    ride the reverse pass; the masked-in leaves still get theirs."""
    a, m, y0 = _problem()
    ts = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    idx = torch.tensor([0, 1, 2])
    seen = []

    def field(t, y, args):
        a_, (m_, ix), scale = args
        seen.append(tuple(id(x) for x in (m_, ix)))
        return tuple(-a_ * v + torch.tanh(m_[ix] @ v) * scale for v in y)

    at = torch.tensor(a, requires_grad=True)
    mt = torch.tensor(m, requires_grad=True)
    scale = torch.tensor(0.5, requires_grad=True)
    ys = odeint_grid_backsolve(field, tuple(torch.tensor(v) for v in y0), ts,
                               (at, (mt, idx), scale), diff_mask=(True, True, False))
    sum(v.sum() for v in ys).backward()
    assert at.grad is not None and mt.grad is not None and scale.grad is None
    # the integer index reaches every evaluation unchanged (never detached)
    assert {s[1] for s in seen} == {id(idx)}
    with pytest.raises(ValueError, match="diff_mask"):
        odeint_grid_backsolve(field, tuple(torch.tensor(v) for v in y0), ts,
                              (at, (mt, idx), scale), diff_mask=(True, False))


@pytest.mark.parametrize("method,spmm", [("euler", "dense"), ("rk4", "dense"),
                                         ("rk4", "pallas2")])
def test_gnode_backsolve_step_matches_jax_and_direct(karate, method, spmm):
    """One C7-field loss and its gradient with adjoint='backsolve': against the
    JAX GNODE with backsolve (1e-5 of each leaf's scale) and, with rk4, against
    the port's direct (2e-3); the adjacency, K1's plain version on the CPU,
    takes no gradient. With euler at deltaT 0.5 the reverse reconstruction is
    first-order and the gradient is not close to direct's (in either
    package), so euler is held to JAX only."""
    n = karate.n_nodes
    jm = JaxGNODE(hidden=8, max_time=6, method=method, adjoint="backsolve")
    pj = jm.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(1)
    i0 = np.zeros((2, n), np.float32)
    i0[0, [2, 5]] = 1.0
    i0[1, 7] = 1.0
    xs = (1.0 - i0, i0, np.zeros_like(i0), np.float32([0.3, 0.2]), np.float32([0.1, 0.4]))
    labels = rng.dirichlet([2.0, 1.0, 1.0], size=(2, 6, n)).astype(np.float32)

    def jloss(p):
        return jax_l1(jm.predict(p, jax_adjacency(karate), *xs), labels)

    jval, jgrad = jax.value_and_grad(jloss)(pj)
    jleaves = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jgrad)))

    adj = adjacency_from_graph(Graph(n_nodes=n, src=karate.src, dst=karate.dst), kind=spmm,
                               device="cpu")
    results = {}
    for adjoint in ("backsolve", "direct"):
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
        for _, leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        pred = GNODE(hidden=8, max_time=6, method=method, adjoint=adjoint).predict(
            params, adj, *(torch.as_tensor(x) for x in xs))
        loss = l1_sir_loss(pred, torch.as_tensor(labels))
        loss.backward()
        results[adjoint] = (loss.item(), {k: v.grad.numpy() for k, v in tree_leaves(params)})
    loss, grads = results["backsolve"]
    assert loss == pytest.approx(float(jval), rel=1e-6)
    assert loss == pytest.approx(results["direct"][0], rel=1e-6)
    for k, g in grads.items():
        if k == "dec2/b":  # shifts all three logits: its gradient is rounding noise
            continue
        scale = np.abs(jleaves[k]).max()
        assert np.abs(g - jleaves[k]).max() <= RTOL_SAME * scale + 1e-8, k
        if method == "rk4":
            assert np.abs(g - results["direct"][1][k]).max() <= RTOL_DIRECT * scale + 1e-8, k
