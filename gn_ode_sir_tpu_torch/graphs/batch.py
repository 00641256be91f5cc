"""Static-shape multi-graph batching (the port's copy of
``gn_ode_sir_tpu.graphs.batch``; numpy only).

Every graph of a collection is padded once to a common (n_max, e_max); a
batch of B trials is then a gather of per-graph rows: [B, n_max] node states
and [B, e_max] edge lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gn_ode_sir_tpu_torch.graphs.graph import Graph


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A collection of graphs padded to shared static shapes.

    Attributes (G = number of graphs):
      src, dst: int32 [G, e_max] — padded entries: src=0, dst=n_max-1
        (keeps each row dst-sorted).
      edge_w:  float32 [G, e_max] — 1.0 for real edges, 0.0 padding.
      node_mask: float32 [G, n_max] — 1.0 for real nodes.
      n_nodes, n_edges: int32 [G] — true sizes.
      names: tuple of dataset stems.
    """

    src: np.ndarray
    dst: np.ndarray
    edge_w: np.ndarray
    node_mask: np.ndarray
    n_nodes: np.ndarray
    n_edges: np.ndarray
    names: tuple

    @property
    def num_graphs(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_max(self) -> int:
        return int(self.node_mask.shape[1])

    @property
    def e_max(self) -> int:
        return int(self.src.shape[1])


def pad_graphs(graphs: list[Graph], node_multiple: int = 8, edge_multiple: int = 128) -> GraphBatch:
    """Pad a list of graphs to common (n_max, e_max), each rounded up to its
    multiple (the JAX package's, so that both pad to the same shapes)."""
    n_max = _round_up(max(g.n_nodes for g in graphs), node_multiple)
    e_max = _round_up(max(g.n_edges for g in graphs), edge_multiple)
    G = len(graphs)
    src = np.zeros((G, e_max), dtype=np.int32)
    dst = np.zeros((G, e_max), dtype=np.int32)
    edge_w = np.zeros((G, e_max), dtype=np.float32)
    node_mask = np.zeros((G, n_max), dtype=np.float32)
    n_nodes = np.zeros(G, dtype=np.int32)
    n_edges = np.zeros(G, dtype=np.int32)
    for i, g in enumerate(graphs):
        # n_pad keeps padding dst at n_max-1, so the list stays dst-sorted
        s, d, w = g.padded_edges(e_max, n_pad=n_max)
        src[i], dst[i], edge_w[i] = s, d, w
        node_mask[i, : g.n_nodes] = 1.0
        n_nodes[i] = g.n_nodes
        n_edges[i] = g.n_edges
    return GraphBatch(
        src=src,
        dst=dst,
        edge_w=edge_w,
        node_mask=node_mask,
        n_nodes=n_nodes,
        n_edges=n_edges,
        names=tuple(g.name for g in graphs),
    )


def batch_index_graphs(batch: GraphBatch, graph_idx: np.ndarray):
    """Gather per-trial edge structure for a batch of trials: ``graph_idx``
    is an int array [B] of graph ids. Returns (src, dst, edge_w, node_mask)
    with a leading batch axis."""
    gi = np.asarray(graph_idx)
    return (
        batch.src[gi],
        batch.dst[gi],
        batch.edge_w[gi],
        batch.node_mask[gi],
    )
