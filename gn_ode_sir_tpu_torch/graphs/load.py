"""Loaders for networkx graph pickles (port of ``gn_ode_sir_tpu.graphs.load``).

Unpickle, undirect, restrict to the largest connected component. networkx
is imported inside :func:`load_graph` only, so the package imports on a
machine without it; there a pickle of the port's own :class:`Graph` loads
as it is (how a worker process on such a machine gets its dataset).
"""

from __future__ import annotations

import dataclasses
import os
import pickle

from gn_ode_sir_tpu_torch.graphs.graph import Graph, graph_from_networkx

# the directory of the reference's dataset strings ('./real_graphs/<name>')
GRAPH_STEM = "real_graphs"


def _stem(path: str) -> str:
    base = os.path.basename(path)
    return base[:-4] if base.endswith(".pkl") else base


def load_graph(path: str, n_random: int = 50, seed: int = 0) -> Graph:
    """Load one graph. ``path`` may omit the ``.pkl`` suffix; the pickle holds
    a networkx graph or a :class:`Graph` (named after the file).

    ``path == 'none'`` returns a G(n, 0.2) random graph, the reference's
    fallback dataset.
    """
    if path == "none":
        import networkx as nx

        G = nx.fast_gnp_random_graph(n_random, 0.2, seed=seed)
        return graph_from_networkx(G, name=f"gnp{n_random}")

    pkl = path if path.endswith(".pkl") else path + ".pkl"
    if not os.path.exists(pkl) and not os.path.isabs(pkl):
        # reference-style relative paths resolve against GN_ODE_SIR_DATA_ROOT
        root = os.environ.get("GN_ODE_SIR_DATA_ROOT")
        if root and os.path.exists(os.path.join(root, pkl)):
            pkl = os.path.join(root, pkl)
    with open(pkl, "rb") as f:
        G = pickle.load(f)
    if isinstance(G, Graph):
        return dataclasses.replace(G, name=_stem(path))
    import networkx as nx

    G = G.to_undirected()
    largest_cc = max(nx.connected_components(G), key=len)
    G = G.subgraph(largest_cc)
    return graph_from_networkx(G, name=_stem(path))


def load_graphs(dataset: str, root: str | None = None) -> list[Graph]:
    """Load a '+'-joined multi-graph dataset string.

    ``dataset`` may be either ``'./real_graphs/a+b+c'`` (reference style) or
    a bare ``'a+b+c'`` with ``root`` given.
    """
    if root is None:
        root, names = os.path.split(dataset)
    else:
        names = dataset
    return [load_graph(os.path.join(root, name)) for name in names.split("+")]
