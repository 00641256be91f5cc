"""Immutable static-shape graph container (port of ``gn_ode_sir_tpu.graphs.graph``).

A graph is preprocessed once on the host into a dst-sorted directed COO edge
list; the adjacency backends in :mod:`gn_ode_sir_tpu_torch.ops.adjacency`
build their device tensors from it.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """A static undirected graph stored as a directed COO edge list.

    Attributes:
      n_nodes: number of nodes (ids are 0..n_nodes-1).
      src, dst: int32 arrays of length ``n_edges``; an undirected edge
        contributes both (u, v) and (v, u). Edges are sorted by ``dst``
        (then ``src``), so a CSR row pointer over ``dst`` is one cumsum.
      name: dataset stem (e.g. "karate").
    """

    n_nodes: int
    src: np.ndarray
    dst: np.ndarray
    name: str = "graph"

    def __post_init__(self):
        object.__setattr__(self, "src", np.asarray(self.src, dtype=np.int32))
        object.__setattr__(self, "dst", np.asarray(self.dst, dtype=np.int32))
        if self.src.shape != self.dst.shape or self.src.ndim != 1:
            raise ValueError("src/dst must be 1-D arrays of equal length")

    @property
    def n_edges(self) -> int:
        """Number of *directed* edges (2x the undirected edge count)."""
        return int(self.src.shape[0])

    @cached_property
    def degrees(self) -> np.ndarray:
        """In-degree per node (== out-degree for undirected graphs)."""
        return np.bincount(self.dst, minlength=self.n_nodes).astype(np.int32)

    @cached_property
    def dense_adjacency(self) -> np.ndarray:
        """Dense float32 {0,1} adjacency, ``a[dst, src] = 1``."""
        a = np.zeros((self.n_nodes, self.n_nodes), dtype=np.float32)
        a[self.dst, self.src] = 1.0
        return a

    def padded_edges(
        self, e_max: int, n_pad: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Edge arrays padded to a static length ``e_max``.

        Padding edges carry weight 0 and ``dst = n_pad - 1`` (>= every real
        dst), so the padded list stays dst-sorted. Returns (src, dst, weight)
        with shape [e_max] each.
        """
        e = self.n_edges
        if e_max < e:
            raise ValueError(f"e_max={e_max} < n_edges={e}")
        pad_dst = (n_pad if n_pad is not None else self.n_nodes) - 1
        src = np.zeros(e_max, dtype=np.int32)
        dst = np.full(e_max, pad_dst, dtype=np.int32)
        w = np.zeros(e_max, dtype=np.float32)
        src[:e], dst[:e], w[:e] = self.src, self.dst, 1.0
        return src, dst, w


def graph_from_edges(n_nodes: int, undirected_edges, name: str = "graph") -> Graph:
    """Build a :class:`Graph` from undirected (u, v) pairs.

    ``undirected_edges`` is an iterable of pairs or an integer array of shape
    [m, 2]. Self-loops are kept as a single directed edge; duplicate
    undirected edges are deduplicated (networkx Graph semantics).
    """
    if isinstance(undirected_edges, np.ndarray):
        pairs = undirected_edges.astype(np.int64).reshape(-1, 2)
    else:
        pairs = np.asarray(
            [(int(u), int(v)) for u, v in undirected_edges], dtype=np.int64
        ).reshape(-1, 2)
    if pairs.size and (pairs.min() < 0 or pairs.max() >= n_nodes):
        bad = pairs[(pairs < 0).any(1) | (pairs >= n_nodes).any(1)][0]
        raise ValueError(
            f"edge ({bad[0]}, {bad[1]}) has a node id outside "
            f"[0, {n_nodes}) — node ids must be 0..n_nodes-1"
        )
    from gn_ode_sir_tpu_torch import native

    out = native.coalesce_undirected(pairs, n_nodes)
    if out is not None:
        return Graph(n_nodes=n_nodes, src=out[0], dst=out[1], name=name)

    # numpy fallback: canonical-code dedup, symmetrize, (dst, src) sort
    n = int(n_nodes)
    a = np.minimum(pairs[:, 0], pairs[:, 1])
    b = np.maximum(pairs[:, 0], pairs[:, 1])
    codes = np.unique(a * n + b)
    ca, cb = codes // n, codes % n
    loops = ca == cb
    src = np.concatenate([ca, cb[~loops]])
    dst = np.concatenate([cb, ca[~loops]])
    order = np.lexsort((src, dst))  # sort by dst, then src
    return Graph(
        n_nodes=n_nodes,
        src=src[order].astype(np.int32),
        dst=dst[order].astype(np.int32),
        name=name,
    )


def graph_from_networkx(G, name: str = "graph") -> Graph:
    """Convert a networkx graph, relabelling nodes to 0..n-1 in the
    iteration order of ``G.nodes()``."""
    nodes = list(G.nodes())
    index = {u: i for i, u in enumerate(nodes)}
    edges = ((index[u], index[v]) for u, v in G.edges())
    return graph_from_edges(len(nodes), edges, name=name)
