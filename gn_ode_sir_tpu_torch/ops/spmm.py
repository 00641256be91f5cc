"""Sparse matrix-matrix multiply (port of ``gn_ode_sir_tpu.ops.spmm``).

Two strategies, chosen by graph size: a dense matmul with the materialized
{0,1} adjacency up to ``DENSE_NODE_THRESHOLD`` nodes, and above it the
dst-sorted edge list — in the port, the CUDA kernel of
:mod:`gn_ode_sir_tpu_torch.ops.spmm2`. The COO functions here are the plain
gather + ``index_add_`` form.
"""

from __future__ import annotations

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
