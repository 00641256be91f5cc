"""What the metric files share. Each reader takes the run (``cell``,
``cfg``, ``traffic``, ``setup_s``, ``window``, ``traced``, ``trace``,
``shapes``, ``on_card``) and returns a number, or None where it finds
nothing to read. Shares of a peak or a roofline are never clipped: a share
above 100% means the counts or the time are wrong."""

from __future__ import annotations

import sys

from perfbench import profiling
from perfbench.counts import gnode, spmm
from perfbench.counts import labels as label_counts
from perfbench.counts.peaks import H100


def _is_k1(name: str) -> bool:
    return "spmm2" in name


def _is_k1_apply(name: str) -> bool:
    """K1's segment kernel, one launch an apply (the fixup is its second
    kernel where rows were cut)."""
    return "spmm2" in name and "fixup" not in name


def evals(cfg: dict) -> int:
    """Field evaluations these inputs need: up to the last label time."""
    m = cfg["model"]
    return round((m["max_time"] - 1) / m["delta_t"])


def grid_evals(cfg: dict) -> int:
    """Field evaluations the program's solver makes: the whole grid
    ``arange(0, max_time, delta_t)``, one step past the last label time."""
    m = cfg["model"]
    return round(m["max_time"] / m["delta_t"]) - 1


def _gnode_shape(run, graph: int, batch: int) -> dict:
    m = run.cfg["model"]
    g = run.shapes[graph]
    return {"n": g["n"], "edges": g["edges"], "batch": batch, "hidden": m["hidden"],
            "evals": evals(run.cfg), "label_times": m["max_time"], "encode_r": m["encode_r"]}


def train_flops(run, units) -> float:
    return sum(gnode.train_step_flops(**_gnode_shape(run, g, b)) for g, b in units)


def serve_flops(run, requests: int) -> float:
    per = run.traffic["scenarios_per_request"]
    return requests * gnode.forward_flops(**_gnode_shape(run, 0, per))


def share(part: float, whole: float):
    return None if whole <= 0 else 100.0 * part / whole


def device_idle(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.wall_s)


def k1_roofline(run, applies: list, launched: int) -> float | None:
    """``applies``: (graph, batch) of every K1 and K1-bwd apply these inputs
    need in the traced stretch; ``launched``: the applies the program's
    solver makes there, cross-checked against the trace and the program's
    counter."""
    if run.trace is None:
        return None
    seen = run.trace.count(_is_k1_apply)
    if not (seen == launched == run.traced["k1_applies"]):
        print(f"K1 applies: {seen} in the trace, {run.traced['k1_applies']} counted by the "
              f"program, {launched} expected", file=sys.stderr)
        return None
    h = run.cfg["model"]["hidden"]
    bound = sum(spmm.k1_apply(run.shapes[g]["n"], run.shapes[g]["edges"], b, h)["bound_s"]
                for g, b in applies)
    return share(bound, run.trace.busy_s(_is_k1))


def train_k1(run) -> float | None:
    """K1 forward and K1-bwd, one of each an evaluation of every step."""
    units = run.traced["units"] if run.traced else []
    need = [(g, b) for g, b in units for _ in range(2 * evals(run.cfg))]
    return k1_roofline(run, need, 2 * grid_evals(run.cfg) * len(units))


def serve_k1(run) -> float | None:
    """K1 forward, one an evaluation of every dispatch."""
    per, cap = run.traffic["scenarios_per_request"], run.traffic["dispatch_batch"]
    requests = run.traced["requests"] if run.traced else 0
    chunks = [min(cap, per - lo) for lo in range(0, per, cap)]
    need = [(0, b) for _ in range(requests) for b in chunks for _ in range(evals(run.cfg))]
    return k1_roofline(run, need, requests * len(chunks) * grid_evals(run.cfg))


def label_work(run, rec) -> dict:
    """Trial steps and rows of a label stretch."""
    lab = run.cfg["labels"]
    return {"trial_steps": rec["trials"] * (lab["max_time"] - 1), "sims": lab["sims"],
            "n": run.shapes[0]["n"]}


def labels_ops(run, rec) -> float:
    w = label_work(run, rec)
    return w["trial_steps"] * label_counts.count_product(w["sims"], w["n"])["ops"]


def count_product_roofline(run):
    if run.trace is None:
        return None
    matmul = lambda name: profiling.kernel_group(name) == "matmul (cuBLAS)"
    products = run.trace.count(matmul)
    if products == 0:
        return None
    w = label_work(run, run.traced)
    per_trial = label_counts.count_product(w["sims"], w["n"])
    ops = w["trial_steps"] * per_trial["ops"]
    # the adjacency is read once a product, the rows once a trial step
    bytes_moved = w["trial_steps"] * (per_trial["bytes"] - w["n"] ** 2) + products * w["n"] ** 2
    bound = max(ops / H100["int8_ops"], bytes_moved / H100["hbm_bytes_per_s"])
    return share(bound, run.trace.busy_s(matmul))


def k2_roofline(run):
    if run.trace is None:
        return None
    w = label_work(run, run.traced)
    bound = w["trial_steps"] * label_counts.k2_step(w["sims"], w["n"])["bound_s"]
    return share(bound, run.trace.busy_s(lambda name: "sir_step" in name))
