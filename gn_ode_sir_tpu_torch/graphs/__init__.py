"""Graph ingestion and batching (port of ``gn_ode_sir_tpu.graphs``)."""

from gn_ode_sir_tpu_torch.graphs.batch import GraphBatch, batch_index_graphs, pad_graphs
from gn_ode_sir_tpu_torch.graphs.graph import Graph, graph_from_edges, graph_from_networkx
from gn_ode_sir_tpu_torch.graphs.load import GRAPH_STEM, load_graph, load_graphs

__all__ = [
    "GRAPH_STEM",
    "Graph",
    "GraphBatch",
    "graph_from_edges",
    "graph_from_networkx",
    "load_graph",
    "load_graphs",
    "pad_graphs",
    "batch_index_graphs",
]
