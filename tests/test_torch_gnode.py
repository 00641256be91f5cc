"""Port parity: the GN-ODE (gn_ode_sir_tpu_torch.models / odeint) against the
JAX package, from JAX-initialised params carried across with
``params_from_numpy`` (jax.random and torch.Generator draw different
numbers, so parity always starts from the same params).

f32 probabilities agree to atol 1e-5. The legacy C6 variant (relu, rk4,
layer-normed derivative) amplifies f32 rounding differences along the
trajectory at some inits — there the JAX package's own dense and COO
paths end far apart (for example hidden 16, PRNGKey(1)) — so its case
uses an init at which the reference itself is stable, and checks that
first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.models.common import layer_norm as jax_layer_norm
from gn_ode_sir_tpu.models.gnode import GNODE as JaxGNODE
from gn_ode_sir_tpu.models.gnode import legacy_dense_gnode as jax_legacy
from gn_ode_sir_tpu.models.gnode import solver_policy as jax_solver_policy
from gn_ode_sir_tpu.odeint import odeint_grid as jax_odeint_grid
from gn_ode_sir_tpu.ops.adjacency import adjacency_from_graph as jax_adjacency
from gn_ode_sir_tpu.ops.pallas_spmm2 import Pallas2Adj
from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.models.common import layer_norm, linear_init
from gn_ode_sir_tpu_torch.models.gnode import GNODE, legacy_dense_gnode, solver_policy
from gn_ode_sir_tpu_torch.odeint import odeint_grid, resample_integer_times
from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
from gn_ode_sir_tpu_torch.train.checkpoint import params_from_numpy

torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(n, seeds=((2, 5), (7,)), beta=(0.3, 0.2), gamma=(0.1, 0.4)):
    b = len(seeds)
    i0 = np.zeros((b, n), np.float32)
    for j, s in enumerate(seeds):
        i0[j, list(s)] = 1.0
    return (1.0 - i0, i0, np.zeros_like(i0), np.asarray(beta, np.float32),
            np.asarray(gamma, np.float32))


def _params(jmodel, seed=1):
    pj = jmodel.init(jax.random.PRNGKey(seed))
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")


def _port_graph(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


def _run(model, params, adj, xs, fn="predict"):
    with torch.inference_mode():
        return getattr(model, fn)(params, adj, *(torch.as_tensor(a) for a in xs)).numpy()


@pytest.mark.parametrize("fn", ["predict", "apply"])
def test_c7_dense_matches_jax(karate, fn):
    """C7 (sigmoid/euler), B=2 on karate, dense adjacency."""
    jm, tm = JaxGNODE(hidden=16), GNODE(hidden=16)
    pj, pt = _params(jm)
    xs = _inputs(karate.n_nodes)
    want = np.asarray(getattr(jm, fn)(pj, jax_adjacency(karate), *xs))
    got = _run(tm, pt, adjacency_from_graph(_port_graph(karate), device="cpu"), xs, fn)
    assert got.shape == want.shape == ((20 if fn == "predict" else 40), 2, karate.n_nodes, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_c7_k1_adjacency_matches_jax_pallas2(karate, precision):
    """C7 through the port's K1 adjacency (plain version on CPU) against the
    JAX Pallas2Adj in interpret mode at small K/R."""
    jm, tm = JaxGNODE(hidden=16), GNODE(hidden=16)
    pj, pt = _params(jm)
    xs = _inputs(karate.n_nodes)
    jadj = Pallas2Adj.from_graph(karate, k_edges=16, r_rows=8, precision=precision)
    want = np.asarray(jm.predict(pj, jadj, *xs))
    kind = "pallas2" if precision == "f32" else "pallas2-bf16"
    got = _run(tm, pt, adjacency_from_graph(_port_graph(karate), kind=kind, device="cpu"), xs)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_c6_legacy_matches_jax(karate):
    """C6 legacy_dense_gnode (relu/rk4/deriv-LN), single trial, at an init
    where the reference itself is stable (its dense and COO paths agree)."""
    jm, tm = jax_legacy(hidden=16), legacy_dense_gnode(hidden=16)
    pj, pt = _params(jm, seed=0)
    xs = _inputs(karate.n_nodes, seeds=((2, 5),), beta=(0.3,), gamma=(0.1,))
    want = np.asarray(jm.predict(pj, jax_adjacency(karate), *xs))
    coo = np.asarray(jm.predict(pj, jax_adjacency(karate, kind="coo"), *xs))
    np.testing.assert_allclose(coo, want, atol=ATOL)  # the reference is stable here
    got = _run(tm, pt, adjacency_from_graph(_port_graph(karate), device="cpu"), xs)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("method", ["midpoint", "rk4", "dopri5"])
def test_other_fixed_grid_methods_match_jax(random_graph, method):
    jm, tm = JaxGNODE(hidden=8, method=method), GNODE(hidden=8, method=method)
    pj, pt = _params(jm, seed=2)
    xs = _inputs(random_graph.n_nodes, seeds=((0, 3), (9,)))
    want = np.asarray(jm.predict(pj, jax_adjacency(random_graph), *xs))
    got = _run(tm, pt, adjacency_from_graph(_port_graph(random_graph), device="cpu"), xs)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_bf16_compute_dtype_matches_jax_loosely(karate):
    """compute_dtype='bf16': state and field params in bf16, decode in f32.
    Both sides round to bf16 after every op of the field and the euler
    update, so the f32 tolerance holds (measured gap 1.2e-7 on this case).
    The bf16 run must differ from the f32 run (gap ~1e-2 here) by far more
    than that tolerance, or the precision was ignored."""
    jm = JaxGNODE(hidden=16, compute_dtype="bf16")
    tm = GNODE(hidden=16, compute_dtype="bf16")
    pj, pt = _params(jm)
    xs = _inputs(karate.n_nodes)
    want = np.asarray(jm.predict(pj, jax_adjacency(karate), *xs))
    adj = adjacency_from_graph(_port_graph(karate), device="cpu")
    got = _run(tm, pt, adj, xs)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    f32 = _run(GNODE(hidden=16), pt, adj, xs)
    assert np.abs(got - f32).max() > 100 * ATOL


@pytest.mark.parametrize("case", [
    dict(n_nodes=34, hidden=64, batch_size=2, max_time=20, delta_t=0.5),
    dict(n_nodes=33_696, hidden=64, batch_size=8, max_time=20, delta_t=0.5),
    dict(n_nodes=7_066, hidden=64, batch_size=1, max_time=20, delta_t=0.5, unroll=4),
    dict(n_nodes=100, hidden=32, batch_size=4, max_time=10, delta_t=0.25,
         adjoint="checkpoint"),
    dict(n_nodes=100, hidden=32, batch_size=4, max_time=10, delta_t=0.5,
         budget_bytes=10),
])
def test_solver_policy_matches_jax_on_cpu(case):
    assert solver_policy(**case) == jax_solver_policy(**case)


def test_predict_is_resampled_apply(random_graph):
    tm = GNODE(hidden=8)
    pt = tm.init(torch.Generator().manual_seed(0), device="cpu")
    adj = adjacency_from_graph(_port_graph(random_graph), device="cpu")
    xs = _inputs(random_graph.n_nodes)
    full = torch.as_tensor(_run(tm, pt, adj, xs, "apply"))
    np.testing.assert_array_equal(
        _run(tm, pt, adj, xs), resample_integer_times(full, 20, 0.5).numpy())


def test_init_shapes_bounds_and_seed():
    tm = GNODE(hidden=8)
    p = tm.init(torch.Generator().manual_seed(3), device="cpu")
    jp = JaxGNODE(hidden=8).init(jax.random.PRNGKey(0))
    shapes = lambda t: {k: {kk: tuple(vv.shape) for kk, vv in v.items()} for k, v in t.items()}
    assert shapes(p) == shapes(jp)
    assert float(p["func"]["w"].abs().max()) <= 1 / np.sqrt(8)
    q = tm.init(torch.Generator().manual_seed(3), device="cpu")
    torch.testing.assert_close(p["dec1"]["w"], q["dec1"]["w"], rtol=0, atol=0)
    legacy = legacy_dense_gnode(hidden=8).init(torch.Generator().manual_seed(0), device="cpu")
    assert set(legacy) == set(jax_legacy(hidden=8).init(jax.random.PRNGKey(0)))
    lin = linear_init(torch.Generator().manual_seed(0), 0, 3, device="cpu")
    assert lin["w"].shape == (0, 3) and float(lin["b"].abs().max()) <= 1.0


def test_layer_norm_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 16)).astype(np.float32)
    s = np.linspace(0.5, 1.5, 16).astype(np.float32)
    b = np.linspace(-1, 1, 16).astype(np.float32)
    got = layer_norm(torch.as_tensor(s), torch.as_tensor(b), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_layer_norm(s, b, jnp.asarray(x))),
                               atol=1e-6)


def _jax_field(t, y, args):
    a, c = args
    return (-a * y[0] + y[1], c * jnp.sin(y[0]))


def _torch_field(t, y, args):
    a, c = args
    return (-a * y[0] + y[1], c * torch.sin(y[0]))


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4", "dopri5"])
def test_odeint_grid_tuple_state_matches_jax(method):
    rng = np.random.default_rng(1)
    y0 = tuple(rng.standard_normal((2, 3)).astype(np.float32) for _ in range(2))
    ts = np.arange(0.0, 3.0, 0.1, dtype=np.float32)
    want = jax_odeint_grid(_jax_field, tuple(map(jnp.asarray, y0)), jnp.asarray(ts),
                           (0.7, 1.3), method=method)
    got = odeint_grid(_torch_field, tuple(map(torch.as_tensor, y0)), ts, (0.7, 1.3),
                      method=method)
    for g, w in zip(got, want):
        assert g.shape == (30, 2, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_checkpoint_adjoint_gradients_equal_direct():
    """'checkpoint' recomputes each step in the backward pass; its gradient
    equals plain autograd's."""
    ts = np.arange(0.0, 1.0, 0.25, dtype=np.float32)
    grads = []
    for adjoint in ("direct", "checkpoint"):
        a = torch.tensor(0.7, requires_grad=True)
        y0 = (torch.ones(3), torch.zeros(3))
        traj = odeint_grid(_torch_field, y0, ts, (a, 1.3), method="rk4", adjoint=adjoint)
        traj[0].sum().backward()
        grads.append(a.grad.item())
    assert grads[0] == pytest.approx(grads[1], rel=1e-6)


def test_unported_solver_options_raise():
    """The backsolve adjoint and adaptive dopri5 run now (held against JAX in
    test_torch_adjoint.py and test_torch_dopri.py); unknown names are still
    refused."""
    y0 = (torch.ones(2),)
    ts = np.arange(0.0, 1.0, 0.5, dtype=np.float32)
    field = lambda t, y, args: (-y[0],)
    (traj,) = odeint_grid(field, y0, ts, adjoint="backsolve")
    assert traj.shape == (2, 2) and torch.equal(traj[0], y0[0])
    with pytest.raises(ValueError, match="adjoint"):
        odeint_grid(field, y0, ts, adjoint="magic")
    with pytest.raises(ValueError, match="method"):
        odeint_grid(field, y0, ts, method="heun")
    probs = GNODE(hidden=4, max_time=2, method="dopri5_adaptive").predict(
        GNODE(hidden=4).init(torch.Generator(), device="cpu"),
        adjacency_from_graph(Graph(n_nodes=2, src=[0, 1], dst=[1, 0]), device="cpu"),
        torch.ones(1, 2), torch.zeros(1, 2), torch.zeros(1, 2), torch.ones(1), torch.ones(1))
    assert probs.shape == (2, 1, 2, 3) and torch.isfinite(probs).all()
    with pytest.raises(ValueError, match="method"):
        GNODE(hidden=4, method="heun").predict(
            GNODE(hidden=4).init(torch.Generator(), device="cpu"), None,
            *(torch.zeros(1, 2),) * 3, torch.zeros(1), torch.zeros(1))