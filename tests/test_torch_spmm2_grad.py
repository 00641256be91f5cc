"""Port parity: K1's gradient (gn_ode_sir_tpu_torch.ops.spmm2) against
``jax.vjp`` of the JAX package's ``Pallas2Adj.matvec`` (its Pallas kernel in
interpret mode, at small chunk geometry), on a weighted DIRECTED edge list,
so that the transpose plan really differs from the forward plan.

f32: the two sides differ in summation order only (1e-5). bf16: both round
the cotangent and the weights to bf16 and each message to
bf16(bf16(g) * bf16(w)), then sum in f32 (1e-5 as well). On the CPU the
port's kernel wrapper runs its plain version; the autograd Function around
it is the same on both devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.ops.pallas_spmm2 import Pallas2Adj
from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.ops.spmm2 import Spmm2Adj, spmm2, spmm2_plain

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def _directed_graph(n=40, e=170, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.choice(n * n, size=e, replace=False)
    dst, src = np.sort(codes) // n, np.sort(codes) % n  # dst-sorted, asymmetric
    w = rng.uniform(0.5, 1.5, e).astype(np.float32)
    return Graph(n_nodes=n, src=src, dst=dst, name="directed"), w


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("batched", [False, True])
def test_k1_gradient_matches_jax_vjp(precision, batched):
    g, w = _directed_graph()
    rng = np.random.default_rng(1)
    shape = (3, g.n_nodes, 8) if batched else (1, g.n_nodes, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    jadj = Pallas2Adj.from_graph(g, w=w, k_edges=16, r_rows=8, precision=precision)
    jout, vjp = jax.vjp(jadj.matvec, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))

    adj = Spmm2Adj.from_graph(g, w=w, precision=precision, device="cpu")
    xt = torch.tensor(x if batched else x[0], requires_grad=True)  # [B, n, h] or [n, h]
    out = adj.matvec(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.as_tensor(ct if batched else ct[0]))
    jout, jdx = np.asarray(jout), np.asarray(jdx)
    if not batched:
        jout, jdx = jout[0], jdx[0]
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=RTOL, atol=ATOL)
    assert dx.dtype == torch.float32 and dx.shape == xt.shape


def _hub_graph(n=48, seed=5):
    """A weighted directed graph whose node 0 receives 150 edges and whose
    node 1 sends 100, so that both the forward and the transpose plan cut a
    row into several work items."""
    rng = np.random.default_rng(seed)
    pairs = np.concatenate([
        np.stack([rng.integers(1, n, 150), np.zeros(150, np.int64)], axis=1),
        np.stack([np.ones(100, np.int64), rng.integers(0, n, 100)], axis=1),
        rng.integers(0, n, (120, 2))])
    order = np.argsort(pairs[:, 1], kind="stable")
    src, dst = pairs[order, 0], pairs[order, 1]
    w = rng.uniform(0.5, 1.5, src.size).astype(np.float32)
    return Graph(n_nodes=n, src=src, dst=dst, name="hub"), w


@pytest.mark.parametrize("h", [5, 8])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_k1_narrow_gradient_matches_jax_vjp(precision, h):
    """At the widths of K1's narrow route on the card (h = 5: GIN's first
    layer, h = 8: the published multi-graph hidden), batch 8, on a graph
    with rows longer than a work item in both directions: value and
    gradient against ``jax.vjp`` of the JAX package's ``custom_vjp``
    (1e-5)."""
    g, w = _hub_graph()
    rng = np.random.default_rng(h)
    x = rng.standard_normal((8, g.n_nodes, h)).astype(np.float32)
    ct = rng.standard_normal((8, g.n_nodes, h)).astype(np.float32)
    jadj = Pallas2Adj.from_graph(g, w=w, k_edges=16, r_rows=8, precision=precision)
    jout, vjp = jax.vjp(jadj.matvec, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))

    adj = Spmm2Adj.from_graph(g, w=w, precision=precision, device="cpu")
    assert adj.plan.fix_row.numel() and adj.plan_t.fix_row.numel()
    xt = torch.tensor(x, requires_grad=True)
    out = adj.matvec(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.as_tensor(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=RTOL, atol=ATOL)


def test_bf16_gradient_rounds_the_cotangent_not_the_casts():
    """In bf16 mode the gradient is K1 on the transpose plan with bf16
    messages. Plain autograd through ``spmm2_plain`` differentiates the casts
    instead and gives another (f32-weighted) gradient."""
    g, w = _directed_graph(seed=3)
    adj = Spmm2Adj.from_graph(g, w=w, precision="bf16", device="cpu")
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((2, g.n_nodes, 16)).astype(np.float32),
                     requires_grad=True)
    ct = torch.as_tensor(rng.standard_normal((2, g.n_nodes, 16)).astype(np.float32))
    (dx,) = torch.autograd.grad(adj.matvec(x), x, ct)
    want = spmm2_plain(adj.plan_t, ct, "bf16")
    np.testing.assert_array_equal(dx.numpy(), want.numpy())
    (auto,) = torch.autograd.grad(spmm2_plain(adj.plan, x, "bf16"), x, ct)
    assert (dx - auto).abs().max() > 1e-3


def test_transpose_plan_is_the_transpose():
    g, w = _directed_graph(seed=4)
    adj = Spmm2Adj.from_graph(g, w=w, device="cpu")
    a = np.zeros((g.n_nodes, g.n_nodes), np.float32)
    a[g.dst, g.src] = w
    eye = torch.eye(g.n_nodes)
    np.testing.assert_allclose(spmm2(adj.plan, eye).numpy(), a, atol=1e-7)
    np.testing.assert_allclose(spmm2(adj.plan_t, eye).numpy(), a.T, atol=1e-7)
    assert np.all(np.diff(adj.plan_t.dst.numpy()) >= 0)


@pytest.mark.parametrize("adjoint", ["direct", "checkpoint"])
def test_gnode_gradients_through_k1_match_dense(random_graph, adjoint):
    """The whole model's gradient through the K1 Function (with and without
    ``torch.utils.checkpoint`` around each step) equals the gradient through
    the dense adjacency; inference mode still works; a bf16 state gets a
    bf16 gradient back."""
    from gn_ode_sir_tpu_torch.models.gnode import GNODE
    from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph

    jg = random_graph
    g = Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)
    model = GNODE(hidden=8, max_time=4, adjoint=adjoint)
    i0 = torch.zeros((2, g.n_nodes))
    i0[0, 3] = i0[1, 7] = 1.0
    xs = (1 - i0, i0, torch.zeros_like(i0), torch.tensor([0.3, 0.2]), torch.tensor([0.1, 0.4]))
    grads = {}
    for kind in ("dense", "pallas2"):
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        leaves = [t.requires_grad_(True) for p in params.values() for t in p.values()]
        adj = adjacency_from_graph(g, kind=kind, device="cpu")
        model.predict(params, adj, *xs)[..., 1].sum().backward()
        grads[kind] = [t.grad.clone() for t in leaves]
        with torch.inference_mode():
            assert model.predict(params, adj, *xs).shape == (4, 2, g.n_nodes, 3)
    for a, b in zip(grads["pallas2"], grads["dense"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)
    xb = torch.randn(2, g.n_nodes, 4).to(torch.bfloat16).requires_grad_(True)
    adjacency_from_graph(g, kind="pallas2", device="cpu").matvec(xb).sum().backward()
    assert xb.grad.dtype == torch.bfloat16
