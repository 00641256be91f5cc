"""Bucketed-ELL SpMM: scatter-free message passing (port of
``gn_ode_sir_tpu.ops.ell``).

Nodes are sorted by degree and grouped into buckets whose padded neighbour
width K is the next power of two of the bucket's largest degree, so the
gathered work is at most 2E whatever the degree skew. Each bucket is a dense
[n_b, K] neighbour-index matrix whose padding points at a zero row appended
to the features; aggregation is a gather [B, n_b, K, h] and a sum over K,
and one inverse-permutation gather brings the rows back to node order.

The JAX package computes this with plain XLA gathers (no ``pallas_call``),
so the port's :class:`EllAdj` is plain torch indexing too: it is the
``ell`` adjacency kind, picked only by name (``auto`` takes K1 above 8,192
nodes). The buckets are built once per graph on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x - 1).bit_length())


def row_offsets_from_sorted_dst(dst: np.ndarray, n_nodes: int) -> np.ndarray:
    """CSR-style row offsets [n_nodes+1] from a dst-sorted edge list."""
    counts = np.bincount(np.asarray(dst), minlength=n_nodes)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def build_ell_buckets(graph, max_buckets: int = 10):
    """Host-side bucket construction. Returns (bucket_idx_list, inv_perm).

    bucket_idx_list: list of int32 [n_b, K_b] neighbour matrices (sorted-node
    order, padding = n_nodes); inv_perm: int32 [n] mapping original node id
    -> row in the concatenated bucket output.
    """
    n = graph.n_nodes
    deg = graph.degrees
    # CSR over dst-sorted edges: node u's in-neighbours are src[off[u]:off[u+1]]
    offsets = row_offsets_from_sorted_dst(graph.dst, n)
    order = np.argsort(-deg, kind="stable").astype(np.int32)  # degree descending
    ks = np.array([_next_pow2(int(deg[u])) for u in order], np.int64)

    # consecutive sorted nodes that share one padded width form a bucket
    buckets = []
    start = 0
    while start < n:
        k = ks[start]
        end = start
        while end < n and ks[end] == k:
            end += 1
        buckets.append((start, end, int(k)))
        start = end
    while len(buckets) > max_buckets:
        # merge the two trailing buckets (the low-degree nodes)
        s0, _, k0 = buckets[-2]
        _, e1, k1 = buckets[-1]
        buckets = buckets[:-2] + [(s0, e1, max(k0, k1))]

    bucket_idx = []
    for s, e, k in buckets:
        k = max(k, 1)
        idx = np.full((e - s, k), n, np.int32)  # padding -> the zero row
        for row, u in enumerate(order[s:e]):
            lo, hi = offsets[u], offsets[u + 1]
            idx[row, : hi - lo] = graph.src[lo:hi]
        bucket_idx.append(idx)

    inv_perm = np.empty(n, np.int32)
    inv_perm[order] = np.arange(n, dtype=np.int32)
    return bucket_idx, inv_perm


@dataclasses.dataclass(frozen=True)
class EllAdj:
    """Bucketed-ELL adjacency of an unweighted {0,1} graph: ``matvec`` on
    x [B, n, h] returns A·x, differentiable through torch's own gathers."""

    bucket_idx: tuple  # of long [n_b, K_b]
    inv_perm: torch.Tensor  # long [n]
    n_nodes: int

    @classmethod
    def from_graph(cls, graph, max_buckets: int = 10, *, device) -> "EllAdj":
        idx_list, inv_perm = build_ell_buckets(graph, max_buckets)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
        return cls(bucket_idx=tuple(as_t(i) for i in idx_list), inv_perm=as_t(inv_perm),
                   n_nodes=graph.n_nodes)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, n, h] -> [B, n, h] = A @ x per batch element."""
        b, _, h = x.shape
        xp = torch.cat([x, x.new_zeros((b, 1, h))], dim=1)
        out_sorted = torch.cat([xp[:, idx, :].sum(dim=2) for idx in self.bucket_idx], dim=1)
        return out_sorted[:, self.inv_perm, :]
