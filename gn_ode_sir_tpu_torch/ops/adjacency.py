"""Adjacency backends for model code (port of ``gn_ode_sir_tpu.ops.adjacency``).

Message passing is ``adj.matvec(x)`` with ``x`` of shape [B, n, h]; every
backend returns float32.

- :class:`DenseAdj` — a matmul with the materialized adjacency (f32 or bf16).
- :class:`CooAdj`   — gather + ``index_add_`` over a shared [E] edge list, or
  over per-sample padded [B, E] edge rows (heterogeneous multi-graph batches).
- :class:`~gn_ode_sir_tpu_torch.ops.ell.EllAdj` — bucketed-ELL gathers.
- :class:`~gn_ode_sir_tpu_torch.ops.spmm2.Spmm2Adj` — the CUDA kernel K1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gn_ode_sir_tpu_torch.ops.spmm import DENSE_NODE_THRESHOLD, spmm_coo_batched, spmm_dense

KINDS = ("auto", "dense", "dense-bf16", "coo", "ell", "pallas2", "pallas2-bf16")


@dataclasses.dataclass(frozen=True)
class DenseAdj:
    """Dense adjacency [n, n] (shared) or [B, n, n] (per-sample).

    With a bf16 ``a`` (exact for {0,1}) the activations are rounded to bf16
    and the product is taken in f32 — bf16 x bf16 products are exact in f32
    and the sum is f32, which is what the JAX einsum with
    ``preferred_element_type=float32`` computes (a bf16 ``torch.matmul``
    would round its result to bf16)."""

    a: torch.Tensor

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return spmm_dense(self.a, x.to(torch.bfloat16) if self.a.dtype == torch.bfloat16 else x)


@dataclasses.dataclass(frozen=True)
class CooAdj:
    """COO adjacency. ``src``/``dst`` are [E] (shared across the batch) or
    [B, E] (per-sample, padded; padding edges carry ``w == 0``)."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor | None
    n_nodes: int

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.src.dim() == 1:
            return spmm_coo_batched(self.src, self.dst, x, self.n_nodes, self.w)
        # per-sample edges: sample b's rows live at offset b * n of the
        # flattened [B * n, h] state, so one gather and one index_add_ serve
        # the whole batch
        b, n, h = x.shape
        offset = torch.arange(b, device=x.device)[:, None] * n
        msgs = x.reshape(b * n, h)[(self.src + offset).reshape(-1)]
        if self.w is not None:
            msgs = msgs * self.w.reshape(-1, 1)
        out = torch.zeros((b * n, h), dtype=x.dtype, device=x.device)
        # out of place: runs under torch.func.vmap (ensemble evaluation)
        return out.index_add(0, (self.dst + offset).reshape(-1), msgs).reshape(b, n, h)


def adjacency_from_graph(graph, *, kind: str = "auto", device):
    """Build the adjacency for a host-side :class:`Graph` on ``device``.

    ``kind``: 'auto' (dense up to ``DENSE_NODE_THRESHOLD`` nodes, K1 above
    it, on any device — on a CPU tensor K1 runs its plain version), or an
    explicit 'dense' | 'dense-bf16' | 'coo' | 'ell' | 'pallas2' |
    'pallas2-bf16'."""
    if kind not in KINDS:
        raise ValueError(f"unknown adjacency kind {kind!r}")
    if kind == "auto":
        kind = "dense" if graph.n_nodes <= DENSE_NODE_THRESHOLD else "pallas2"
    if kind in ("dense", "dense-bf16"):
        dtype = torch.bfloat16 if kind == "dense-bf16" else torch.float32
        return DenseAdj(torch.as_tensor(graph.dense_adjacency, device=device).to(dtype))
    if kind == "coo":
        return CooAdj(torch.as_tensor(graph.src, device=device),
                      torch.as_tensor(graph.dst, device=device), None, graph.n_nodes)
    if kind == "ell":
        from gn_ode_sir_tpu_torch.ops.ell import EllAdj

        return EllAdj.from_graph(graph, device=device)
    from gn_ode_sir_tpu_torch.ops.spmm2 import Spmm2Adj

    return Spmm2Adj.from_graph(
        graph, precision="bf16" if kind.endswith("bf16") else "f32", device=device)


def adjacency_from_batch(batch, graph_idx, *, device) -> CooAdj:
    """Per-trial CooAdj rows for a padded multi-graph batch (gather only)."""
    gi = np.asarray(graph_idx)
    as_t = lambda a: torch.as_tensor(a[gi], device=device)
    return CooAdj(as_t(batch.src).long(), as_t(batch.dst).long(), as_t(batch.edge_w),
                  batch.n_max)
