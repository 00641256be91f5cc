"""Kernel layer: message-passing primitives (port of ``gn_ode_sir_tpu.ops``).

- ``segment_sum`` / ``segment_prod`` — ``index_add_`` / ``scatter_reduce_``
  over edge lists,
- ``spmm_dense`` / ``spmm_coo`` / ``spmm_coo_batched`` — plain SpMM,
- ``spmm`` — the dispatching SpMM over a host ``Graph`` (dense up to
  ``DENSE_NODE_THRESHOLD`` nodes, else COO),
- ``EllAdj`` / ``build_ell_buckets`` / ``row_offsets_from_sorted_dst``
  (``ops.ell``) — the bucketed-ELL adjacency, plain torch gathers,
- ``gcn_norm_edges`` — the GCN baseline's normalised edge weights (host),
- ``spmm2`` (``ops.spmm2``) — K1, the hand-written CUDA SpMM for the
  large-graph path, built from ``csrc/`` by ``ops._kernels`` at first use.
- ``gnode_step`` (``ops.gnode_step``) — K3, the GN-ODE's euler SIR update
  of the no-grad forward as one CUDA kernel, and its plain version.
"""

from gn_ode_sir_tpu_torch.ops.segment import segment_prod, segment_sum
from gn_ode_sir_tpu_torch.ops.spmm import (
    DENSE_NODE_THRESHOLD,
    gcn_norm_edges,
    spmm,
    spmm_coo,
    spmm_coo_batched,
    spmm_dense,
)
from gn_ode_sir_tpu_torch.ops.ell import EllAdj, build_ell_buckets, row_offsets_from_sorted_dst

__all__ = [
    "segment_sum",
    "segment_prod",
    "spmm",
    "spmm_coo",
    "spmm_coo_batched",
    "spmm_dense",
    "gcn_norm_edges",
    "DENSE_NODE_THRESHOLD",
    "EllAdj",
    "build_ell_buckets",
    "row_offsets_from_sorted_dst",
]
