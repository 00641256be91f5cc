"""Chip smoke test of the PyTorch/CUDA port (``gn_ode_sir_tpu_torch``).

    python3 chip_smoke.py

Drives the port's serving path on one NVIDIA card at enron size and holds
every hand-written kernel against its plain PyTorch version. Phases, each
printed as one JSON line:

1. device — the card (and ``nvidia-smi``'s name and power limit, raw);
2. build  — every kernel compiled from ``gn_ode_sir_tpu_torch/csrc``;
3. kernel — K1 against its plain version on the card at the serving shapes
   and at edge cases, with kernel / plain / library times and the bound;
4. serve  — C7 GN-ODE (hidden 64, euler, deltaT 0.5, maxTime 20) with
   seeded random params, scored through ``cli.worker``/``cli.infer``:
   16 summary scenarios in dispatches of 8 and 2 full-trajectory scenarios,
   K1 launch counts per dispatch, and the card's output against the same
   path on the CPU;
5. kernels — one line listing every ported kernel;
and last ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from gn_ode_sir_tpu_torch.cli import infer, worker
from gn_ode_sir_tpu_torch.graphs.graph import Graph, graph_from_edges
from gn_ode_sir_tpu_torch.ops import _kernels
from gn_ode_sir_tpu_torch.ops.spmm2 import CsrPlan, Spmm2Adj, spmm2, spmm2_plain
from gn_ode_sir_tpu_torch.train.checkpoint import save_params

SEED = 0
ENRON_NODES = 33_696  # enron's largest connected component
ENRON_DIRECTED_EDGES = 361_000  # ~enron's directed edge count
HUB_MIN_DEGREE = 1_000
SERVE_SCENARIOS = 16
DISPATCH_BATCH = 8
EULER_STEPS = 39  # maxTime 20 / deltaT 0.5 = 40 grid points
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 (non-tensor-core) rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KERNEL_REL_TOL = 1e-5  # |kernel - plain| <= tol * (1 + sum_e |w_e x_src|)
SERVE_ATOL = 1e-4  # card vs CPU probabilities after 39 steps


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def powerlaw_graph(n: int, n_directed: int, seed: int):
    """A seeded Chung-Lu power-law graph with exactly ``n_directed`` directed
    edges (no self-loops, no duplicates), node ids shuffled."""
    rng = np.random.default_rng(seed)
    weight = np.arange(1, n + 1, dtype=np.float64) ** -0.55
    weight /= weight.sum()
    want = n_directed // 2
    codes = np.zeros(0, np.int64)
    while codes.size < want:
        pairs = rng.choice(n, size=(int(1.2 * (want - codes.size)) + 64, 2), p=weight)
        a, b = pairs.min(axis=1), pairs.max(axis=1)
        codes = np.unique(np.concatenate([codes, (a * n + b)[a != b]]))
    codes = np.sort(rng.choice(codes, size=want, replace=False))
    perm = rng.permutation(n)
    pairs = np.stack([perm[codes // n], perm[codes % n]], axis=1)
    return graph_from_edges(n, pairs, name=f"powerlaw{n}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    report = _kernels.build_all()
    for name in _kernels.KERNELS:
        if not _kernels.library_path(name).exists():
            raise RuntimeError(f"kernel {name} has no library after the build")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": report, "kernels": sorted(_kernels.KERNELS)})


def check_spmm2_case(name, graph, batch, h, precision, x_dtype, *, timed,
                     weighted=False):
    """K1 against its plain version on the card; raises on disagreement."""
    dev = torch.device("cuda")
    rng = np.random.default_rng([SEED, zlib.crc32(name.encode())])
    w = rng.uniform(0.5, 1.5, graph.n_edges).astype(np.float32) if weighted else None
    plan = CsrPlan.build(graph.src, graph.dst, graph.n_nodes, w=w, device=dev)
    x = torch.as_tensor(rng.standard_normal((batch, graph.n_nodes, h), np.float32),
                        device=dev).to(x_dtype)
    got = spmm2(plan, x, precision)
    want = spmm2_plain(plan, x, precision)
    scale = spmm2_plain(dataclasses.replace(plan, w=plan.w.abs()), x.float().abs(), precision)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"{name}: kernel gave {tuple(got.shape)} {got.dtype}")
    err = (got - want).abs()
    bad = err > KERNEL_REL_TOL * (1.0 + scale)
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version at {int(bad.sum())} "
            f"elements (max abs err {float(err.max())})")
    n, e = graph.n_nodes, graph.n_edges
    bytes_moved = x.numel() * x.element_size() + 2 * e * 4 + (n + 1) * 4 + batch * n * h * 4
    flops = 2 * e * batch * h
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    row = {"phase": "kernel", "kernel": "spmm2", "case": name, "n": n, "edges": e,
           "batch": batch, "h": h, "precision": precision,
           "x_dtype": str(x_dtype).replace("torch.", ""),
           "max_abs_err": float(err.max()) if err.numel() else 0.0,
           "tol": f"{KERNEL_REL_TOL} * (1 + sum|w x|)", "ok": True,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if timed:
        row["kernel_ms"] = time_ms(lambda: spmm2(plan, x, precision), 50)
        row["plain_ms"] = time_ms(lambda: spmm2_plain(plan, x, precision), 10)
        row["library_ms"] = None
        if precision == "f32" and x_dtype == torch.float32:
            # yardstick only (never called by the port): one CSR sparse
            # product on the node-major [n, B*h] layout of the same values
            a = torch.sparse_csr_tensor(plan.row_ptr.long(), plan.src.long(), plan.w,
                                        size=(n, n))
            xt = x.permute(1, 0, 2).reshape(n, batch * h).contiguous()
            row["library_ms"] = time_ms(lambda: torch.sparse.mm(a, xt), 50)
    emit(row)
    return row


def phase_kernel(graph) -> dict:
    degmax = int(graph.degrees.max())
    emit({"phase": "graph", "n": graph.n_nodes, "edges": graph.n_edges,
          "max_degree": degmax, "mean_degree": graph.n_edges / graph.n_nodes})
    if degmax < HUB_MIN_DEGREE:
        raise AssertionError(f"power-law graph hub degree {degmax} < {HUB_MIN_DEGREE}")
    f32, bf16 = torch.float32, torch.bfloat16
    main = check_spmm2_case("enron_b8_h64_f32", graph, DISPATCH_BATCH, 64, "f32", f32,
                            timed=True)
    check_spmm2_case("enron_b4_h64_f32", graph, 4, 64, "f32", f32, timed=True)
    check_spmm2_case("enron_b4_h64_bf16msg", graph, 4, 64, "bf16", f32, timed=True)
    check_spmm2_case("enron_b4_h64_bf16x", graph, 4, 64, "f32", bf16, timed=True)
    check_spmm2_case("enron_b2_h64_weighted", graph, 2, 64, "f32", f32, timed=False,
                     weighted=True)
    check_spmm2_case("enron_b2_h8", graph, 2, 8, "f32", f32, timed=False)
    check_spmm2_case("enron_b2_h100", graph, 2, 100, "bf16", f32, timed=False)
    check_spmm2_case("enron_b1_h130_bf16x", graph, 1, 130, "bf16", bf16, timed=False)
    check_spmm2_case("enron_b2_h33", graph, 2, 33, "f32", f32, timed=False)  # odd h: scalar loads
    edgeless = Graph(n_nodes=1000, src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32))
    row = check_spmm2_case("edgeless", edgeless, 2, 64, "f32", f32, timed=False)
    if row["max_abs_err"] != 0.0:
        raise AssertionError("edgeless graph must give exact zeros")
    return main


def phase_serve(graph) -> dict:
    argv = ["--model", "ode_nn", "--hidden", "64", "--method", "euler",
            "--deltaT", "0.5", "--maxTime", "20", "--spmm", "auto"]
    args = worker.build_parser().parse_args([*argv, "--device", "cuda"])
    t0 = time.perf_counter()
    model, adj = worker.build_model_and_adj(args, graph, batch_size=DISPATCH_BATCH)
    if not isinstance(adj, Spmm2Adj):
        raise AssertionError(f"--spmm auto picked {type(adj).__name__}, not the K1 adjacency")
    with tempfile.TemporaryDirectory() as ckpt:
        save_params(ckpt, model.init(torch.Generator().manual_seed(SEED), device="cpu"))
        params = infer.restore_params(ckpt, device="cuda")
        params_cpu = infer.restore_params(ckpt, device="cpu")
    infer.check_params_match(model, params)
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(SEED)
    seeds = [sorted(rng.choice(graph.n_nodes, 3, replace=False).tolist())
             for _ in range(SERVE_SCENARIOS)]
    beta = rng.uniform(0.1, 0.5, SERVE_SCENARIOS)
    gamma = rng.uniform(0.05, 0.3, SERVE_SCENARIOS)
    sb = infer.scenario_batch(graph.n_nodes, seeds, beta, gamma)
    two = tuple(a[:2] for a in sb)

    # warm-up dispatch (kernel library load, cuBLAS handles, allocator)
    t0 = time.perf_counter()
    infer.predict_summaries(model, params, adj, *(a[:DISPATCH_BATCH] for a in sb))
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    spmm2.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    rows = infer.predict_summaries(model, params, adj, *sb, dispatch_batch=DISPATCH_BATCH)
    t_summ = time.perf_counter() - t0
    launches_summ = spmm2.launches
    t0 = time.perf_counter()
    out = infer.predict_scenarios(model, params, adj, *two)
    t_full = time.perf_counter() - t0
    launches = spmm2.launches  # the main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_dispatch = -(-SERVE_SCENARIOS // DISPATCH_BATCH)
    if launches_summ != n_dispatch * EULER_STEPS or launches != (n_dispatch + 1) * EULER_STEPS:
        raise AssertionError(
            f"K1 launches {launches_summ} (summaries) / {launches} (total): expected "
            f"{EULER_STEPS} per dispatch over {n_dispatch} + 1 dispatches")
    if out.shape != (20, 2, graph.n_nodes, 3) or not np.isfinite(out).all():
        raise AssertionError(f"serving output {out.shape} is not finite [20, 2, n, 3]")
    if np.abs(out.sum(-1) - 1.0).max() > 1e-5:
        raise AssertionError("probabilities do not sum to 1 within 1e-5")
    vals = np.asarray([[r["peak_infected_frac"], r["final_recovered_frac"]] for r in rows])
    if len(rows) != SERVE_SCENARIOS or not np.isfinite(vals).all() or not all(
            0 <= r["peak_time"] < 20 for r in rows):
        raise AssertionError("summary rows are malformed")

    # reference: the port's same serving path on the CPU (K1's plain version)
    args_cpu = worker.build_parser().parse_args([*argv, "--device", "cpu"])
    model_cpu, adj_cpu = worker.build_model_and_adj(args_cpu, graph, batch_size=2)
    t0 = time.perf_counter()
    ref = infer.predict_scenarios(model_cpu, params_cpu, adj_cpu, *two)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(out - ref).max())
    if err > SERVE_ATOL:
        raise AssertionError(f"card vs CPU serving output max abs err {err} > {SERVE_ATOL}")

    row = {"phase": "serve", "n": graph.n_nodes, "edges": graph.n_edges, "hidden": 64,
           "method": "euler", "grid_points": EULER_STEPS + 1,
           "adjacency": type(adj).__name__, "setup_s": setup_s, "warmup_s": warm_s,
           "summary_scenarios": SERVE_SCENARIOS, "dispatch_batch": DISPATCH_BATCH,
           "summary_s": t_summ, "scenarios_per_s": SERVE_SCENARIOS / t_summ,
           "ms_per_dispatch": t_summ / n_dispatch * 1e3,
           "full_trajectory_scenarios": 2, "full_trajectory_s": t_full,
           "k1_launches": launches, "k1_launches_per_dispatch": EULER_STEPS,
           "peak_memory_gb": peak_gb, "cpu_reference_s": cpu_s,
           "max_abs_err_vs_cpu": err, "atol": SERVE_ATOL, "ok": True}
    emit(row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    # full-f32 matmuls: TF32 would quietly change every dense A·Z and linear
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    graph = powerlaw_graph(ENRON_NODES, ENRON_DIRECTED_EDGES, SEED)
    k1 = phase_kernel(graph)
    serve = phase_serve(graph)
    emit({"kernels": [{
        "name": "spmm2", "route": "cuda",
        "source": "gn_ode_sir_tpu_torch/csrc/spmm2.cu",
        "replaces": "gn_ode_sir_tpu/ops/pallas_spmm2.py:119",
        "launches": serve["k1_launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
