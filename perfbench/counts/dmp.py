"""The least bytes of DMP's recursion (``models/dmp.py``): what a time step
has to read and write, each input byte read once and each output byte
written once, as the reference's ``step`` (``reference/dmp.py``) takes and
gives them, in float32 (``elem`` = 4).

A step from t-1 to t, per scenario:
- edges: theta, phi and Ps_ij read (theta is not read at t = 1, where it
  starts at 1), and written: 6 elements an edge, 5 at t = 1;
- nodes: Pi and Pr at t-1 and Ps(0) read, Ps, Pi and Pr at t written: 6
  elements a node;
- rates: beta and gamma read: 2 elements.
Not counted: the edge structure (src, dst, the reverse edge; read once a
step whatever the batch, 12 bytes an edge in int32, under 0.4% of a step at
128 scenarios), and intermediates a fused step keeps on chip or in L2 (the
node product, 4 bytes a node and scenario). A share from these counts is
therefore a lower bound. At enron's 33,696 nodes and 361,622 edges over 19
steps this is 26.0 bytes an edge update.
"""

from perfbench.counts.peaks import H100


def step_elements(n: int, edges: int, batch: int, first: bool) -> int:
    """Elements one step reads and writes for ``batch`` scenarios."""
    return batch * ((5 if first else 6) * edges + 6 * n + 2)


def least_bytes(n: int, edges: int, batch: int, steps: int, elem: int = 4) -> int:
    """Bytes of ``steps`` steps from t = 0 (a dispatch of max_time - 1)."""
    return elem * sum(step_elements(n, edges, batch, k == 0) for k in range(steps))


def bytes_per_edge_update(n: int, edges: int, steps: int, elem: int = 4) -> float:
    """:func:`least_bytes` over its batch x edges x steps edge updates (the
    batch cancels)."""
    return least_bytes(n, edges, 1, steps, elem) / (edges * steps)


def bound_s(edge_updates: int, n: int, edges: int, steps: int, elem: int = 4) -> float:
    """The least time of ``edge_updates`` edge updates made in dispatches of
    ``steps`` steps on one graph, at HBM's rate."""
    return edge_updates * bytes_per_edge_update(n, edges, steps, elem) / H100["hbm_bytes_per_s"]
