"""Graph ingestion (port of ``gn_ode_sir_tpu.graphs``)."""

from gn_ode_sir_tpu_torch.graphs.graph import Graph, graph_from_edges, graph_from_networkx
from gn_ode_sir_tpu_torch.graphs.load import load_graph

__all__ = ["Graph", "graph_from_edges", "graph_from_networkx", "load_graph"]
