"""Multi-graph experiment assembly (port of
``gn_ode_sir_tpu.train.multigraph``).

One model trains across graphs of different sizes: every graph is padded
once to (n_max, e_max), a trial carries an explicit ``graph_idx``, and the
same ``fit`` engine serves single- and multi-graph experiments through
``adj_fn(graph_idx) -> adjacency`` (``graph_idx``: the minibatch's graph ids,
a numpy array on the host).

Split protocol: all trials of the first G-1 graphs train; the last graph's
trials split half val / half test, so evaluation measures transfer to an
UNSEEN graph.

Backends: ``dense`` gathers per-trial blocks of a [G, n, n] stack, ``coo``
gathers padded per-trial edge rows, and ``pallas2`` — the name the JAX
package gives its kernel backend, kept for the flags' sake — applies K1
(``ops.spmm2``, the CUDA kernel; its plain version on CPU tensors) with one
graph's plan to a graph-homogeneous minibatch. Its connectivity is simply a
list of :class:`~gn_ode_sir_tpu_torch.ops.spmm2.Spmm2Adj`, one per graph,
each built over that graph's real edges only: one list at the train width
for the non-eval graphs, one at full width for all. A minibatch therefore
costs its own graph's edges by construction, which is what the JAX package
reaches with per-graph chunk grids; its stacked and padded plans
(``stacked_plans``, ``_pad_plan``, ``Pallas2SwitchAdj``) and the chunk
geometry arguments have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from gn_ode_sir_tpu_torch.graphs import GraphBatch, pad_graphs
from gn_ode_sir_tpu_torch.ops.adjacency import CooAdj, DenseAdj
from gn_ode_sir_tpu_torch.ops.spmm2 import Spmm2Adj
from gn_ode_sir_tpu_torch.sim.mc_sir import MAX_SEED, fold_seed
from gn_ode_sir_tpu_torch.train.data import build_trial_data

MG_DENSE_BYTES_LIMIT = 2 << 30  # auto picks dense below this stack size


def resolve_mg_kind(batch: GraphBatch, gcn_normalized: bool = False) -> str:
    """Resolve the 'auto' multigraph adjacency backend by scale: the dense
    [G, n, n] stack (bf16 for the {0,1} case, f32 when GCN-normalized) while
    it stays under ``MG_DENSE_BYTES_LIMIT``, else K1 ('pallas2') on any
    device — callers then batch graph-homogeneously."""
    itemsize = 4 if gcn_normalized else 2
    stack_bytes = batch.num_graphs * batch.n_max * batch.n_max * itemsize
    return "dense" if stack_bytes <= MG_DENSE_BYTES_LIMIT else "pallas2"


@dataclasses.dataclass
class MultigraphConnectivity:
    """Resolved multigraph connectivity, backend-agnostic.

    Produced by :func:`multigraph_auto_fns`; feed straight into the training
    engine with ``fit(model, opt, params, data, tr, va, te,
    **conn.fit_kwargs(), ...)``. ``kind`` records the resolved backend
    ('dense' | 'coo' | 'pallas2'); ``batch_by_graph`` is True exactly when
    the backend needs graph-homogeneous minibatches.
    """

    adj_fn: object
    eval_adj_fn: object
    node_mask_fn: object
    batch_by_graph: bool
    kind: str

    def fit_kwargs(self) -> dict:
        return {
            "adj_fn": self.adj_fn,
            "eval_adj_fn": self.eval_adj_fn,
            "node_mask_fn": self.node_mask_fn,
            "batch_by_graph": self.batch_by_graph,
        }


def _ids(graph_idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(graph_idx), dtype=torch.long, device=device)


def _node_mask_fn(batch: GraphBatch, device):
    mask = torch.as_tensor(batch.node_mask, device=device)
    return lambda graph_idx: mask[_ids(graph_idx, device)]


def multigraph_auto_fns(batch: GraphBatch, *, gcn_normalized: bool = False,
                        eval_graph: int = -1, kind: str = "auto",
                        train_node_view: bool | None = None, precision: str = "f32",
                        device) -> MultigraphConnectivity:
    """Zero-config multigraph connectivity on ``device``: resolve the backend
    by scale, including K1 with grouped batches above the dense limit (the
    worker's ``--mg_adj auto``).

    ``train_node_view`` (default on) runs training at the width of the
    largest non-eval graph for the ``dense`` and ``pallas2`` backends;
    ``precision`` ('f32' | 'bf16') is K1's message precision.
    """
    explicit_view = train_node_view is not None
    node_view = True if train_node_view is None else bool(train_node_view)
    if kind == "auto":
        kind = resolve_mg_kind(batch, gcn_normalized=gcn_normalized)
    if kind == "pallas2":
        tr_fn, ev_fn, mask_fn = multigraph_pallas2_fns(
            batch, gcn_normalized=gcn_normalized, eval_graph=eval_graph,
            train_node_view=node_view, precision=precision, device=device)
        return MultigraphConnectivity(tr_fn, ev_fn, mask_fn, True, kind)
    if precision != "f32":
        warnings.warn(
            f"multigraph_auto_fns resolved to the {kind!r} backend; "
            f"the kernel's precision={precision!r} is unused",
            stacklevel=2,
        )
    if kind != "dense" and explicit_view and node_view:
        # the per-sample COO gather has no narrowed variant: an explicit
        # request for the node view must not silently no-op
        warnings.warn(
            f"train_node_view is not implemented for the {kind!r} backend; "
            "training runs at the full padded width",
            stacklevel=2,
        )
    adj_fn, mask_fn = multigraph_adj_fns(
        batch, gcn_normalized=gcn_normalized, kind=kind, device=device)
    train_fn = adj_fn
    if kind == "dense" and batch.num_graphs > 1 and node_view:
        # the unseen-graph protocol means no TRAIN trial ever needs the eval
        # graph's rows: a train stack sliced once, on the device, cuts each
        # train step's [B, n, n] @ [B, n, h] work by (n_max / n_train)^2
        _, train_ids, remap, n_train = _train_bucket(batch, eval_graph)
        if n_train < batch.n_max:
            dense_train = adj_fn.stack[_ids(train_ids, device), :n_train, :n_train]
            remap = torch.as_tensor(remap, dtype=torch.long, device=device)

            def train_fn(graph_idx):
                return DenseAdj(dense_train[remap[_ids(graph_idx, device)]])

            train_fn.n_view = n_train
            train_fn.valid_train_graphs = frozenset(train_ids)
    return MultigraphConnectivity(train_fn, adj_fn, mask_fn, False, kind)


def multigraph_adj_fns(batch: GraphBatch, gcn_normalized: bool = False,
                       kind: str = "auto", *, device):
    """(adj_fn, node_mask_fn) for :func:`gn_ode_sir_tpu_torch.train.fit`,
    their tensors on ``device``; the closures gather per-trial rows.

    ``kind='dense'`` keeps a [G, n_max, n_max] adjacency stack (bf16 for the
    {0,1} case above 512 MiB — exact; f32 below it and when GCN-normalized)
    and gathers per-trial blocks; ``'coo'`` gathers padded edge rows.
    """
    if kind == "auto":
        kind = resolve_mg_kind(batch, gcn_normalized=gcn_normalized)
        if kind == "pallas2":
            # this API cannot carry that backend's calling convention (a
            # separate eval adj_fn and grouped batches): point at the
            # uniform one rather than silently serve the slowest backend
            raise ValueError(
                "auto resolved to the K1 ('pallas2') backend for this batch "
                "size; use multigraph_auto_fns(batch, ...) (uniform API, "
                "handles it) or multigraph_pallas2_fns(batch, ...) with "
                "fit(batch_by_graph=True), or pass kind='coo'/'dense' "
                "explicitly to keep heterogeneous batching"
            )
    if gcn_normalized:
        src, dst, w = _normalized_edges(batch)
    else:
        src, dst, w = batch.src, batch.dst, batch.edge_w
    n_max = batch.n_max
    node_mask_fn = _node_mask_fn(batch, device)

    if kind == "dense":
        dense = np.zeros((batch.num_graphs, n_max, n_max), np.float32)
        for g in range(batch.num_graphs):
            # additive scatter: padding edges land on (n_max-1, 0) with
            # weight 0 and must not overwrite a real entry there
            np.add.at(dense[g], (dst[g], src[g]), w[g])
        # keep f32 exactness when the stack is small; drop to bf16 (exact for
        # the {0,1} adjacency, activations round) only at scale
        f32_bytes = dense.size * 4
        dtype = (torch.float32 if gcn_normalized or f32_bytes <= (512 << 20)
                 else torch.bfloat16)
        stack = torch.as_tensor(dense, device=device).to(dtype)

        def adj_fn(graph_idx):
            return DenseAdj(stack[_ids(graph_idx, device)])

        adj_fn.stack = stack
        return adj_fn, node_mask_fn

    if kind != "coo":
        raise ValueError(f"multigraph_adj_fns builds 'dense' or 'coo', got {kind!r}")
    src_t, dst_t = (torch.as_tensor(a, dtype=torch.long, device=device) for a in (src, dst))
    w_t = torch.as_tensor(w, device=device)

    def adj_fn(graph_idx):
        gi = _ids(graph_idx, device)
        return CooAdj(src_t[gi], dst_t[gi], w_t[gi], n_max)

    return adj_fn, node_mask_fn


def _train_bucket(batch: GraphBatch, eval_graph: int):
    """(eval_id, train_ids, remap, n_train) for the train-side node view.

    One definition of the bucket rule for both backends (dense and K1): the
    train width is the largest non-eval graph's node count rounded up to
    128, capped at the global padding; ``remap[g]`` is g's row in the
    train-only stack.
    """
    G = batch.num_graphs
    ev = eval_graph % G
    train_ids = [g for g in range(G) if g != ev]
    if not train_ids:
        raise ValueError(
            "the unseen-eval-graph protocol needs at least 2 graphs in the "
            "batch (got 1: the eval graph would also be the only train "
            "graph) — use the single-graph path (adjacency_from_graph) "
            "instead")
    remap = np.zeros(G, np.int32)
    remap[train_ids] = np.arange(len(train_ids), dtype=np.int32)
    n_train = int(max(int(batch.n_nodes[g]) for g in train_ids))
    n_train = min(batch.n_max, -(-n_train // 128) * 128)
    return ev, train_ids, remap, n_train


def _real_edge_lists(batch: GraphBatch, graph_ids, gcn_normalized: bool):
    """Per-graph (src, dst, w) over REAL edges only (dst-sorted, the
    GraphBatch layout), so that a plan's work follows its graph's true edge
    count, not the shared e_max padding."""
    if gcn_normalized:
        src, dst, w = _normalized_edges(batch)
    else:
        src, dst, w = batch.src, batch.dst, batch.edge_w
    # real edges fill a row's prefix and are the ones with a weight (a graph
    # that carries self-loops has fewer normalized edges than n_edges + n)
    counts = [int(np.count_nonzero(w[g])) for g in graph_ids]
    return [
        (src[g, :c], dst[g, :c], w[g, :c]) for g, c in zip(graph_ids, counts)
    ]


def multigraph_pallas2_fns(batch: GraphBatch, *, gcn_normalized: bool = False,
                           eval_graph: int = -1, precision: str = "f32",
                           train_node_view: bool = False, device):
    """K1 connectivity for multigraph runs above the dense limit — the
    backend that takes the multi-graph protocol to enron scale.

    Returns ``(train_adj_fn, eval_adj_fn, node_mask_fn)`` for
    ``fit(..., eval_adj_fn=..., batch_by_graph=True)``. The train side holds
    one :class:`Spmm2Adj` per non-eval graph, the eval side one per graph at
    the full padded width, each over its graph's real edges (rows beyond the
    graph's node count are edgeless and come out as zeros).

    Both adj_fns apply ONE graph's plan per minibatch (``graph_idx[0]``, read
    on the host), so batches MUST be graph-homogeneous
    (``fit(batch_by_graph=True)`` builds them). Heterogeneous batching stays
    available via ``multigraph_adj_fns(kind='coo'|'dense')``.

    ``train_node_view=True`` builds the TRAIN adjacency at the train
    bucket's node width (largest non-eval graph, rounded up to 128) and
    declares it via ``train_adj_fn.n_view`` so :func:`fit` runs the train
    epoch at that width. Off by default: direct callers of ``train_adj_fn``
    feed full-width states; :func:`multigraph_auto_fns` turns it on.
    """
    G = batch.num_graphs
    _, train_ids, _, n_train = _train_bucket(batch, eval_graph)
    n_max = batch.n_max
    n_t = n_train if (train_node_view and n_train < n_max) else n_max

    def plans(graph_ids, width):
        return {g: Spmm2Adj.from_edges(s, d, width, w, precision=precision, device=device)
                for g, (s, d, w) in zip(
                    graph_ids, _real_edge_lists(batch, graph_ids, gcn_normalized))}

    full = plans(list(range(G)), n_max)
    train = plans(train_ids, n_t) if n_t < n_max else {g: full[g] for g in train_ids}

    def train_adj_fn(graph_idx):
        return train[int(np.asarray(graph_idx).reshape(-1)[0])]

    def eval_adj_fn(graph_idx):
        return full[int(np.asarray(graph_idx).reshape(-1)[0])]

    if n_t < n_max:
        train_adj_fn.n_view = n_t
    # fit() checks that train_idx stays inside these graphs — declared
    # unconditionally: the train side has no plan for the eval graph even at
    # full width
    train_adj_fn.valid_train_graphs = frozenset(train_ids)
    # fit() refuses to run these with heterogeneous minibatches: one graph's
    # plan serves the WHOLE batch
    train_adj_fn.requires_grouped_batches = True
    eval_adj_fn.requires_grouped_batches = True
    return train_adj_fn, eval_adj_fn, _node_mask_fn(batch, device)


def _normalized_edges(batch: GraphBatch):
    """Per-graph GCN-normalized padded edges (self-loops on real nodes)."""
    G, e_max = batch.src.shape
    n_max = batch.n_max
    e_norm = e_max + n_max  # room for self-loops
    src = np.zeros((G, e_norm), np.int32)
    # padding dst = n_max-1 keeps each row dst-sorted
    dst = np.full((G, e_norm), n_max - 1, np.int32)
    w = np.zeros((G, e_norm), np.float32)
    for g in range(G):
        e = int(batch.n_edges[g])
        n = int(batch.n_nodes[g])
        # add_remaining_self_loops semantics, same as ops.gcn_norm_edges:
        # drop loops the graph already carries before appending one per node
        sg, dg = batch.src[g, :e], batch.dst[g, :e]
        keep = sg != dg
        sg, dg = sg[keep], dg[keep]
        s = np.concatenate([sg, np.arange(n, dtype=np.int32)])
        d = np.concatenate([dg, np.arange(n, dtype=np.int32)])
        deg = np.bincount(d, minlength=n_max).astype(np.float32)
        dinv = np.zeros(n_max, np.float32)
        dinv[:n] = 1.0 / np.sqrt(np.maximum(deg[:n], 1.0))
        ww = dinv[s] * dinv[d]
        order = np.lexsort((s, d))
        m = s.shape[0]  # e - dropped_loops + n
        src[g, :m] = s[order]
        dst[g, :m] = d[order]
        w[g, :m] = ww[order]
    return src, dst, w


def multigraph_split(instances_per_graph, eval_graph: int = -1):
    """(train_idx, val_idx, test_idx) with the unseen-graph protocol: every
    trial of the non-eval graphs trains; the eval graph's trials split
    first-half val / second-half test."""
    counts = list(instances_per_graph)
    G = len(counts)
    eval_graph = eval_graph % G
    offsets = np.concatenate([[0], np.cumsum(counts)])
    train, val, test = [], [], []
    for g in range(G):
        idx = np.arange(offsets[g], offsets[g + 1])
        if g == eval_graph:
            half = len(idx) // 2
            val.extend(idx[:half])
            test.extend(idx[half:])
        else:
            train.extend(idx)
    return np.asarray(train), np.asarray(val), np.asarray(test)


def assemble_multigraph_trials(
    graphs,
    per_graph_params,
    *,
    label_dirs=None,
    sim: int = 10000,
    max_time: int = 20,
    node_multiple: int = 8,
    edge_multiple: int = 128,
    seed: int = 0,
    device,
):
    """Build (GraphBatch, TrialData) for a multi-graph experiment.

    Args:
      graphs: list of :class:`~gn_ode_sir_tpu_torch.graphs.Graph`.
      per_graph_params: per graph, a list of (seed_set, beta, gamma) trials.
      label_dirs: optional per-graph label-cache dirs (reference layout:
        ``Experiments-seed<k>-<graph>``); missing labels are simulated on
        ``device``.
      seed: trial t of graph g draws its simulations from the integer seed
        ``(fold_seed(seed, 0) + g * 100003 + t) mod 2^63``, distinct for
        every graph and trial (fewer than 100,003 trials a graph).
    """
    from gn_ode_sir_tpu_torch.utils import load_or_extract_labels_many

    batch = pad_graphs(graphs, node_multiple, edge_multiple)
    base = fold_seed(seed, 0)

    seed_sets, betas, gammas, triples, graph_idx = [], [], [], [], []
    for g_i, (graph, params) in enumerate(zip(graphs, per_graph_params)):
        save_dir = label_dirs[g_i] if label_dirs else None
        # cache misses are simulated several trials per dispatch
        triples.extend(
            load_or_extract_labels_many(
                graph, list(params), sim=sim, max_time=max_time,
                save_dir=save_dir,
                seeds=[(base + g_i * 100003 + t_i) & MAX_SEED
                       for t_i in range(len(params))],
                device=device,
            )
        )
        for seeds, beta, gamma in params:
            seed_sets.append(seeds)
            betas.append(beta)
            gammas.append(gamma)
            graph_idx.append(g_i)

    data = build_trial_data(
        batch.n_max, seed_sets, betas, gammas, triples,
        graph_idx=graph_idx, n_pad=batch.n_max,
    )
    return batch, data
