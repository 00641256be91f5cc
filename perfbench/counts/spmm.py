"""K1's least time for one apply, ``out[b, d] = sum_{dst[e]=d} w[e] x[b, src[e]]``.

The one copy of this count (``chip_smoke.py::spmm2_bound`` calls it): x
read once, the plan's src and w read once, its row pointer read once, the
float32 result written once, over the memory rate; two operations an edge,
scenario and column over the float32 rate. Here ``n`` is the graph's own node count: rows
a plan carries beyond it (a multi-graph train view padded to 7,168) are not
work these inputs need.
"""

from perfbench.counts.peaks import H100


def k1_apply(n: int, edges: int, batch: int, h: int, x_bytes: int = 4) -> dict:
    """{"ops", "bytes", "bound_s", "bound_by"} of one K1 or K1-bwd apply."""
    bytes_moved = batch * n * h * x_bytes + 2 * edges * 4 + (n + 1) * 4 + batch * n * h * 4
    ops = 2.0 * edges * batch * h
    t_bytes, t_ops = bytes_moved / H100["hbm_bytes_per_s"], ops / H100["f32_flops"]
    return {"ops": ops, "bytes": bytes_moved, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
