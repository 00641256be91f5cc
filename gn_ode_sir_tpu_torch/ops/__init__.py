"""Kernel layer: message-passing primitives (port of ``gn_ode_sir_tpu.ops``).

- ``segment_sum`` — an ``index_add_`` over edge lists,
- ``spmm_dense`` / ``spmm_coo`` / ``spmm_coo_batched`` — plain SpMM,
- ``spmm2`` (``ops.spmm2``) — K1, the hand-written CUDA SpMM for the
  large-graph path, built from ``csrc/`` by ``ops._kernels`` at first use.
"""

from gn_ode_sir_tpu_torch.ops.segment import segment_sum
from gn_ode_sir_tpu_torch.ops.spmm import (
    DENSE_NODE_THRESHOLD,
    spmm_coo,
    spmm_coo_batched,
    spmm_dense,
)

__all__ = [
    "segment_sum",
    "spmm_coo",
    "spmm_coo_batched",
    "spmm_dense",
    "DENSE_NODE_THRESHOLD",
]
