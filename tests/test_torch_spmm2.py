"""Port parity: K1 (gn_ode_sir_tpu_torch.ops.spmm2) and the adjacency
backends against the JAX package.

On the CPU the port's K1 runs its plain version (gather + ``index_add_``);
the JAX side runs its Pallas kernel in interpret mode, at small chunk
geometries (K, R) that force many chunk boundaries per row block. f32
results differ only in summation order (rtol/atol 1e-5). With bf16 messages
both sides round each message to bf16(bf16(x) * bf16(w)) and sum in f32,
so the same tolerance holds. The kernel itself is held against the plain
version in ``tests/test_torch_cuda.py``, which runs only where a card is
visible.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.ops.adjacency import CooAdj as JaxCooAdj
from gn_ode_sir_tpu.ops.adjacency import DenseAdj as JaxDenseAdj
from gn_ode_sir_tpu.ops.pallas_spmm2 import Pallas2Adj, SpmmPlan, spmm_pallas2
from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.ops import spmm_coo, spmm_coo_batched, spmm_dense
from gn_ode_sir_tpu_torch.ops.adjacency import CooAdj, DenseAdj, adjacency_from_graph
from gn_ode_sir_tpu_torch.ops.spmm2 import CsrPlan, Spmm2Adj, spmm2

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def _port_graph(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


def _jax_spmm2(jg, x, w=None, precision="f32"):
    """JAX K1 in interpret mode on [n, h] or [B, n, h] (one call per sample)."""
    plan = SpmmPlan.build(jg.src, jg.dst, jg.n_nodes, w=w, k_edges=16, r_rows=8)
    one = lambda xb: np.asarray(spmm_pallas2(plan, jnp.asarray(xb), interpret=True,
                                             precision=precision))
    return one(x) if x.ndim == 2 else np.stack([one(xb) for xb in x])


@pytest.mark.parametrize("h", [8, 64, 100])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_matches_jax_kernel(random_graph, h, batched, weighted):
    jg = random_graph
    rng = np.random.default_rng(h + 10 * batched + 100 * weighted)
    shape = (3, jg.n_nodes, h) if batched else (jg.n_nodes, h)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, jg.n_edges).astype(np.float32) if weighted else None
    plan = CsrPlan.build(jg.src, jg.dst, jg.n_nodes, w=w, device="cpu")
    out = spmm2(plan, torch.as_tensor(x))
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), _jax_spmm2(jg, x, w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_plain_bf16_messages_match_jax(random_graph, batched):
    jg = random_graph
    rng = np.random.default_rng(11)
    shape = (2, jg.n_nodes, 64) if batched else (jg.n_nodes, 64)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, jg.n_edges).astype(np.float32)
    plan = CsrPlan.build(jg.src, jg.dst, jg.n_nodes, w=w, device="cpu")
    out = spmm2(plan, torch.as_tensor(x), precision="bf16")
    want = _jax_spmm2(jg, x, w, precision="bf16")
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)
    # and the rounding is really there: f32 messages differ by more
    f32 = spmm2(plan, torch.as_tensor(x)).numpy()
    assert np.abs(f32 - want).max() > 1e-3


def test_plain_bf16_state_input_matches_jax(random_graph):
    """A bf16 x (the --gnode_dtype bf16 state) with f32 messages."""
    jg = random_graph
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, jg.n_nodes, 16)).astype(np.float32)).to(torch.bfloat16)
    plan = CsrPlan.build(jg.src, jg.dst, jg.n_nodes, device="cpu")
    out = spmm2(plan, x)
    want = _jax_spmm2(jg, x.float().numpy())
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_edgeless_graph_gives_exact_zeros(precision):
    n = 12
    jplan = SpmmPlan.build(np.zeros(0, np.int32), np.zeros(0, np.int32), n,
                           k_edges=16, r_rows=8)
    x = np.random.default_rng(0).standard_normal((n, 16)).astype(np.float32)
    want = np.asarray(spmm_pallas2(jplan, jnp.asarray(x), interpret=True, precision=precision))
    plan = CsrPlan.build(np.zeros(0, np.int32), np.zeros(0, np.int32), n, device="cpu")
    assert plan.row_ptr.tolist() == [0] * (n + 1)
    out = spmm2(plan, torch.as_tensor(x), precision)
    np.testing.assert_array_equal(out.numpy(), 0.0)
    np.testing.assert_array_equal(want, 0.0)


def test_csr_plan_row_ptr_and_validation(random_graph):
    jg = random_graph
    plan = CsrPlan.build(jg.src, jg.dst, jg.n_nodes, device="cpu")
    np.testing.assert_array_equal(np.diff(plan.row_ptr.numpy()), jg.degrees)
    assert plan.src.numel() == jg.n_edges
    with pytest.raises(ValueError, match="dst-sorted"):
        CsrPlan.build(jg.src, jg.dst[::-1], jg.n_nodes, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        CsrPlan.build(np.array([0, 9]), np.array([0, 1]), 5, device="cpu")


def test_wrapper_rejects_other_devices_and_precisions(random_graph):
    """No silent fallback: only cpu (plain) and cuda (kernel) tensors run."""
    jg = random_graph
    plan = CsrPlan.build(jg.src, jg.dst, jg.n_nodes, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        spmm2(plan, torch.empty((jg.n_nodes, 4), device="meta"))
    with pytest.raises(ValueError, match="precision"):
        spmm2(plan, torch.zeros((jg.n_nodes, 4)), precision="f16")


def test_cpu_calls_do_not_count_launches(random_graph):
    jg = random_graph
    plan = CsrPlan.build(jg.src, jg.dst, jg.n_nodes, device="cpu")
    before = spmm2.launches
    spmm2(plan, torch.zeros((2, jg.n_nodes, 4)))
    assert spmm2.launches == before


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_spmm2_adj_matches_jax_pallas2_adj(random_graph, precision):
    jg = random_graph
    x = np.random.default_rng(4).standard_normal((2, jg.n_nodes, 8)).astype(np.float32)
    jadj = Pallas2Adj.from_graph(jg, k_edges=16, r_rows=8, precision=precision)
    adj = Spmm2Adj.from_graph(_port_graph(jg), precision=precision, device="cpu")
    assert adj.n_nodes == jg.n_nodes
    np.testing.assert_allclose(adj.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(jadj.matvec(jnp.asarray(x))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["dense", "dense-bf16", "coo", "pallas2", "pallas2-bf16"])
def test_adjacency_kinds_match_jax(random_graph, kind):
    """adjacency_from_graph: every kind the port has against the JAX
    backend of the same kind (pallas2 at small K/R, interpret mode)."""
    from gn_ode_sir_tpu.ops.adjacency import adjacency_from_graph as jax_adjacency

    jg = random_graph
    x = np.random.default_rng(5).standard_normal((2, jg.n_nodes, 8)).astype(np.float32)
    if kind.startswith("pallas2"):
        jadj = Pallas2Adj.from_graph(jg, k_edges=16, r_rows=8,
                                     precision="bf16" if kind.endswith("bf16") else "f32")
    else:
        jadj = jax_adjacency(jg, kind=kind)
    out = adjacency_from_graph(_port_graph(jg), kind=kind, device="cpu").matvec(torch.as_tensor(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jadj.matvec(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_dense_adj_bf16_is_f32_product_of_bf16_operands(random_graph):
    """DenseAdj bf16 returns f32 (not a bf16-rounded matmul), and per-sample
    [B, n, n] adjacency works as in JAX."""
    jg = random_graph
    x = np.random.default_rng(6).standard_normal((2, jg.n_nodes, 8)).astype(np.float32)
    a = np.stack([jg.dense_adjacency, jg.dense_adjacency.T * 0.5])
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        out = DenseAdj(torch.as_tensor(a).to(dt_t)).matvec(torch.as_tensor(x))
        want = JaxDenseAdj(jnp.asarray(a, dt_j)).matvec(jnp.asarray(x))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_coo_adj_weighted_matches_jax(random_graph):
    jg = random_graph
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, jg.n_nodes, 4)).astype(np.float32)
    w = rng.random(jg.n_edges).astype(np.float32)
    out = CooAdj(torch.as_tensor(jg.src), torch.as_tensor(jg.dst), torch.as_tensor(w),
                 jg.n_nodes).matvec(torch.as_tensor(x))
    want = JaxCooAdj(jnp.asarray(jg.src), jnp.asarray(jg.dst), jnp.asarray(w),
                     jg.n_nodes).matvec(jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_spmm_functions_match_jax(random_graph):
    from gn_ode_sir_tpu.ops import spmm_coo as jcoo, spmm_coo_batched as jcoob
    from gn_ode_sir_tpu.ops import spmm_dense as jdense

    jg = random_graph
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, jg.n_nodes, 4)).astype(np.float32)
    w = rng.random(jg.n_edges).astype(np.float32)
    s, d = torch.as_tensor(jg.src), torch.as_tensor(jg.dst)
    js, jd = jnp.asarray(jg.src), jnp.asarray(jg.dst)
    pairs = [
        (spmm_coo(s, d, torch.as_tensor(x[0]), jg.n_nodes, torch.as_tensor(w)),
         jcoo(js, jd, jnp.asarray(x[0]), jg.n_nodes, jnp.asarray(w))),
        (spmm_coo_batched(s, d, torch.as_tensor(x), jg.n_nodes),
         jcoob(js, jd, jnp.asarray(x), jg.n_nodes)),
        (spmm_dense(torch.as_tensor(jg.dense_adjacency), torch.as_tensor(x)),
         jdense(jnp.asarray(jg.dense_adjacency), jnp.asarray(x))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_auto_picks_dense_then_k1_on_any_device():
    from gn_ode_sir_tpu_torch.ops.spmm import DENSE_NODE_THRESHOLD

    tiny = Graph(n_nodes=4, src=np.array([1, 0]), dst=np.array([0, 1]))
    assert isinstance(adjacency_from_graph(tiny, device="cpu"), DenseAdj)
    big = Graph(n_nodes=DENSE_NODE_THRESHOLD + 1, src=np.array([1, 0]), dst=np.array([0, 1]))
    adj = adjacency_from_graph(big, device="cpu")
    assert isinstance(adj, Spmm2Adj) and adj.precision == "f32"
    with pytest.raises(NotImplementedError, match="ell"):
        adjacency_from_graph(tiny, kind="ell", device="cpu")
    with pytest.raises(ValueError):
        adjacency_from_graph(tiny, kind="pallas3", device="cpu")
