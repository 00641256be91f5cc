"""Sparse matrix-matrix multiply (port of ``gn_ode_sir_tpu.ops.spmm``).

Two strategies, chosen by graph size: a dense matmul with the materialized
{0,1} adjacency up to ``DENSE_NODE_THRESHOLD`` nodes, and above it the
dst-sorted edge list — in the port, the CUDA kernel of
:mod:`gn_ode_sir_tpu_torch.ops.spmm2`. The COO functions here are the plain
gather + ``index_add_`` form.
"""

from __future__ import annotations

import numpy as np
import torch

from gn_ode_sir_tpu_torch.ops.segment import segment_sum

# Above this node count a dense n*n f32 adjacency (> ~256 MB) stops paying
# for itself; the sparse path takes over.
DENSE_NODE_THRESHOLD = 8192


def spmm_dense(a_dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[..., i, h] = sum_j A[i, j] * x[..., j, h], in float32."""
    return torch.matmul(a_dense.float(), x.float())


def spmm_coo(src, dst, x, n_nodes: int, edge_w=None):
    """COO SpMM for one graph: gather rows by ``src``, sum into ``dst``.

    ``x``: [n_nodes, h]; ``edge_w``: optional [E] weights. Returns [n_nodes, h].
    """
    msgs = x[src]
    if edge_w is not None:
        msgs = msgs * edge_w[:, None]
    return segment_sum(msgs, dst, n_nodes, dim=0)


def spmm_coo_batched(src, dst, x, n_nodes: int, edge_w=None):
    """Batched COO SpMM with shared edges: ``x`` is [B, n_nodes, h]."""
    msgs = x[:, src, :]
    if edge_w is not None:
        msgs = msgs * edge_w[None, :, None]
    return segment_sum(msgs, dst, n_nodes, dim=1)


def spmm(graph, x, edge_w=None, *, prefer_dense: bool | None = None):
    """Dispatching SpMM over a host-side :class:`~gn_ode_sir_tpu_torch.graphs.Graph`,
    on ``x``'s device. ``x`` is [n, h] or [B, n, h].

    The dense product is taken up to ``DENSE_NODE_THRESHOLD`` nodes (unless
    ``prefer_dense`` says otherwise) when no edge weights are given, else
    the plain COO gather and ``index_add``."""
    if prefer_dense is None:
        prefer_dense = graph.n_nodes <= DENSE_NODE_THRESHOLD
    if prefer_dense and edge_w is None:
        return spmm_dense(torch.as_tensor(graph.dense_adjacency, device=x.device), x)
    src = torch.as_tensor(graph.src, dtype=torch.long, device=x.device)
    dst = torch.as_tensor(graph.dst, dtype=torch.long, device=x.device)
    if x.dim() == 2:
        return spmm_coo(src, dst, x, graph.n_nodes, edge_w)
    return spmm_coo_batched(src, dst, x, graph.n_nodes, edge_w)


def gcn_norm_edges(graph, add_self_loops: bool = True):
    """Symmetric GCN normalization D^-1/2 (A + I) D^-1/2, on the host.

    PyG ``add_remaining_self_loops`` semantics: a self-loop the graph already
    carries is dropped before exactly one loop per node is added, so the
    edge-list and the dense backends see the same matrix. Returns dst-sorted
    (src, dst, weight) numpy arrays."""
    src, dst = graph.src, graph.dst
    if add_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        loops = np.arange(graph.n_nodes, dtype=np.int32)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    deg = np.bincount(dst, minlength=graph.n_nodes).astype(np.float32)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    w = dinv[src] * dinv[dst]
    order = np.lexsort((src, dst))
    return src[order], dst[order], w[order].astype(np.float32)
