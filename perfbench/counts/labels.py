"""Operations and bytes of the Monte-Carlo label path (``sim/mc_sir.py``)
for ``rows`` = trials x simulations advancing one step on ``n`` nodes.

- The count product ``I[rows, n] @ A[n, n]`` (``torch._int_mm``, int8 in,
  int32 out): ``2 rows n^2`` operations, the dense product the path computes
  (``utils/roofline.py::mc_sim_model`` counts it so); bytes: I and A read
  once, the int32 counts written once.
- K2 (``csrc/sir_step.cu``): int8 I and R and the int32 counts read once,
  int8 I and R written once, 8 bytes an element.
"""

from perfbench.counts.peaks import H100


def count_product(rows: int, n: int) -> dict:
    ops = 2.0 * rows * n * n
    bytes_moved = rows * n + n * n + 4 * rows * n
    t_ops, t_bytes = ops / H100["int8_ops"], bytes_moved / H100["hbm_bytes_per_s"]
    return {"ops": ops, "bytes": bytes_moved, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k2_step(rows: int, n: int) -> dict:
    bytes_moved = 8 * rows * n
    return {"bytes": bytes_moved, "bound_s": bytes_moved / H100["hbm_bytes_per_s"]}
