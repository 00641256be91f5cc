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

The kernel's host plan (the work list of segments of at most
``SEGMENT_EDGES`` edges) is checked here without a card: its invariants, and
a plain function that walks the list as the kernel does — one partial sum
per item, a long row's partial sums added in segment order — against the
plain version and against the JAX kernel.
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
from gn_ode_sir_tpu_torch.ops.spmm2 import (SEGMENT_EDGES, CsrPlan, Spmm2Adj, spmm2,
                                            spmm2_plain)

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


@pytest.mark.parametrize("h", [1, 3, 5, 8, 16, 64, 100])
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
    from gn_ode_sir_tpu_torch.ops.ell import EllAdj

    assert isinstance(adjacency_from_graph(tiny, kind="ell", device="cpu"), EllAdj)
    with pytest.raises(ValueError):
        adjacency_from_graph(tiny, kind="pallas3", device="cpu")


# --- the kernel's work list -------------------------------------------------

L = SEGMENT_EDGES


def _rows_graph(counts, seed=0):
    """A dst-sorted directed edge list whose row d has counts[d] edges, with
    seeded sources and weights."""
    counts = np.asarray(counts, np.int64)
    n = max(counts.size, 3)
    rng = np.random.default_rng([seed, counts.size])
    dst = np.repeat(np.arange(counts.size), counts)
    src = rng.integers(0, n, dst.size)
    return src, dst, n, rng.uniform(0.5, 1.5, dst.size).astype(np.float32)


def _transposed(src, dst, n, w):
    """The same edges with the roles swapped, sorted by the new dst."""
    order = np.argsort(src, kind="stable")
    return dst[order], src[order], n, w[order]


_star = (np.arange(1, 501), np.zeros(500, np.int64), 501,
         np.linspace(0.5, 1.5, 500).astype(np.float32))
PLAN_CASES = {
    "edgeless": (np.zeros(0, np.int64), np.zeros(0, np.int64), 7, np.zeros(0, np.float32)),
    "star": _star,
    "star_transposed": _transposed(*_star),
    "boundary_rows": _rows_graph([L - 1, L, L + 1, 0, 2 * L, 2 * L + 1, 1, 3]),
    "boundary_rows_transposed": _transposed(
        *_rows_graph([L - 1, L, L + 1, 0, 2 * L, 2 * L + 1, 1, 3])),
    "one_row_exactly_L": _rows_graph([L]),
    "last_row_long": _rows_graph([2, 0, 0, 5 * L + 7]),
    "hubs_between_short_rows": _rows_graph([3, 4 * L, 0, 1, 3 * L + 1, 2, L + 5], seed=3),
}


def _walk_work_list(plan, x, precision="f32"):
    """K1 as the kernel walks its plan: each work item sums its edges'
    messages; an item that is a whole row is the output row, the items of a
    long row are partial sums in slots, added in slot order."""
    work, src, w = plan.work.long(), plan.src.long(), plan.w
    xb = x if x.dim() == 3 else x[None]
    if precision == "bf16":
        msgs = (xb.to(torch.bfloat16)[:, src, :] * w.to(torch.bfloat16)[:, None]).float()
    else:
        msgs = xb.float()[:, src, :] * w[:, None]
    item_of_edge = torch.full((src.numel(),), -1, dtype=torch.long)
    for i, (first, count, _, _) in enumerate(work.tolist()):
        item_of_edge[first:first + count] = i
    sums = torch.zeros((xb.shape[0], work.shape[0], xb.shape[2]))
    sums.index_add_(1, item_of_edge, msgs)
    out = torch.full((xb.shape[0], plan.n_nodes, xb.shape[2]), float("nan"))
    partial = torch.full((xb.shape[0], plan.n_slots, xb.shape[2]), float("nan"))
    for i, (_, _, row, slot) in enumerate(work.tolist()):
        if slot < 0:
            out[:, row] = sums[:, i]
        else:
            partial[:, slot] = sums[:, i]
    fix_ptr = plan.fix_ptr.tolist()
    for j, row in enumerate(plan.fix_row.tolist()):
        acc = torch.zeros_like(out[:, row])
        for s in range(fix_ptr[j], fix_ptr[j + 1]):
            acc = acc + partial[:, s]
        out[:, row] = acc
    return out if x.dim() == 3 else out[0]


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_work_list_covers_every_edge_once_in_dst_order(case):
    src, dst, n, w = PLAN_CASES[case]
    plan = CsrPlan.build(src, dst, n, w=w, device="cpu")
    work = plan.work.numpy().astype(np.int64)
    first, count, row, slot = work.T
    counts = np.bincount(dst, minlength=n)
    assert work.shape[1] == 4 and (count >= 0).all() and (count <= L).all()
    # every row has ceil(count / L) items, at least one
    np.testing.assert_array_equal(np.bincount(row, minlength=n),
                                  np.maximum(1, -(-counts // L)))
    # the items of one row, in list order, tile the row's edges in order
    by_row = np.argsort(row, kind="stable")
    np.testing.assert_array_equal(first[by_row][1:][count[by_row][:-1] > 0],
                                  (first + count)[by_row][:-1][count[by_row][:-1] > 0])
    edges = np.concatenate([np.arange(f, f + c) for f, c in zip(first[by_row], count[by_row])]
                           or [np.zeros(0, np.int64)])
    np.testing.assert_array_equal(edges, np.arange(dst.size))
    assert all((dst[f:f + c] == r).all() for f, c, r in zip(first, count, row))
    # a row of at most L edges is one item that writes the output itself
    whole = counts[row] <= L
    assert (slot[whole] == -1).all() and (np.bincount(row[whole], minlength=n) <= 1).all()
    # the list is sorted by edge count, largest first, ties in (row, edge) order
    assert (np.diff(count) <= 0).all()
    ties = np.diff(count) == 0
    assert (np.diff(row)[ties] >= 0).all() and (np.diff(first)[ties] >= 0).all()
    # the pieces of long rows hold the slots 0, 1, ... in (row, edge) order
    n_cut = int((~whole).sum())
    cut_items = np.flatnonzero(~whole)
    cut_items = cut_items[np.lexsort((first[cut_items], row[cut_items]))]
    np.testing.assert_array_equal(slot[cut_items], np.arange(n_cut))
    assert plan.n_slots == n_cut
    # the fix-up list names each long row once with its range of slots
    fix_row, fix_ptr = plan.fix_row.numpy(), plan.fix_ptr.numpy()
    np.testing.assert_array_equal(fix_row, np.flatnonzero(counts > L))
    assert fix_ptr[0] == 0 and fix_ptr[-1] == n_cut and fix_ptr.size == fix_row.size + 1
    by_slot = np.full(n_cut, -1)
    by_slot[slot[~whole]] = np.flatnonzero(~whole)
    # the plain version's ids: items numbered in (row, edge) order
    natural = np.lexsort((first, row))
    np.testing.assert_array_equal(plan.item_row.numpy(), row[natural])
    np.testing.assert_array_equal(plan.edge_item.numpy(),
                                  np.repeat(np.arange(row.size), count[natural]))
    for j, r in enumerate(fix_row):
        items = by_slot[fix_ptr[j]:fix_ptr[j + 1]]
        assert (row[items] == r).all() and (count[items[:-1]] == L).all()
        assert (np.diff(first[items]) == L).all()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_walking_the_work_list_equals_plain(case, precision):
    """Against the plain version, which sums in the plan's order too, and
    against one flat ``index_add_`` over the edge list (f32 sums in another
    order: 1e-6 relative to the sum of |messages|)."""
    src, dst, n, w = PLAN_CASES[case]
    plan = CsrPlan.build(src, dst, n, w=w, device="cpu")
    x = torch.as_tensor(np.random.default_rng(len(case)).standard_normal(
        (2, n, 8)).astype(np.float32))
    got = _walk_work_list(plan, x, precision)
    want = spmm2_plain(plan, x, precision)
    scale = spmm2_plain(plan, x.abs(), precision)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-6 * (1.0 + scale)).all()
    assert torch.equal(got, want)  # on the CPU index_add_ adds in index order
    xs = x.to(torch.bfloat16) if precision == "bf16" else x
    ws = plan.w.to(xs.dtype)
    flat = torch.zeros_like(want).index_add_(
        1, plan.dst, (xs[:, plan.src.long()] * ws[:, None]).float())
    assert ((got - flat).abs() <= 1e-6 * (1.0 + scale)).all()
    if dst.size == 0:
        assert torch.count_nonzero(got) == 0
    single = _walk_work_list(plan, x[0], precision)
    assert torch.equal(single, got[0])


@pytest.mark.parametrize("case", ["boundary_rows", "boundary_rows_transposed", "star",
                                  "hubs_between_short_rows"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_walking_the_work_list_matches_jax_kernel(case, precision):
    """Against the JAX kernel in interpret mode, tolerance as in
    ``test_plain_matches_jax_kernel``."""
    src, dst, n, w = PLAN_CASES[case]
    x = np.random.default_rng(5).standard_normal((n, 8)).astype(np.float32)
    jplan = SpmmPlan.build(src, dst, n, w=w, k_edges=16, r_rows=8)
    want = np.asarray(spmm_pallas2(jplan, jnp.asarray(x), interpret=True,
                                   precision=precision))
    plan = CsrPlan.build(src, dst, n, w=w, device="cpu")
    got = _walk_work_list(plan, torch.as_tensor(x), precision)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_work_list_of_a_graph_with_short_rows_only(random_graph):
    """Rows of at most L edges: one item per row, no scratch."""
    jg = random_graph
    assert jg.degrees.max() <= L
    plan = CsrPlan.build(jg.src, jg.dst, jg.n_nodes, device="cpu")
    work = plan.work.numpy()
    work = work[np.argsort(work[:, 2])]
    np.testing.assert_array_equal(work[:, 2], np.arange(jg.n_nodes))
    np.testing.assert_array_equal(work[:, 0], plan.row_ptr.numpy()[:-1])
    np.testing.assert_array_equal(work[:, 1], jg.degrees)
    assert (work[:, 3] == -1).all() and plan.n_slots == 0 and plan.fix_row.numel() == 0
