"""Serving latency and device-time breakdown of the PyTorch/CUDA port.

    python3 scripts/torch_serve_profile.py [--batches 1 8 16] [--dispatches 40]

On one NVIDIA card, at the enron-size power-law graph of ``chip_smoke.py``
(n = 33,696, 361,000 directed edges), scores C7 GN-ODE summary requests
(hidden 64, euler, deltaT 0.5, maxTime 20, seeded random params) through
``cli.infer.predict_summaries``:

- per batch size B: ``--dispatches`` timed dispatches of B scenarios after
  two warm-up dispatches; wall time per dispatch (host clock, each dispatch
  ends in a device->host copy) as median, 75th percentile and max, and
  scenarios/s at the median;
- at the largest B: ``torch.profiler`` over three dispatches — device time
  by kernel, K1's share, and the device's idle share of the profiled wall
  (the profiler's own host overhead is inside that wall).

Prints one JSON line per measurement (and writes all of them to ``--out``
when given). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import ENRON_DIRECTED_EDGES, ENRON_NODES, SEED, powerlaw_graph  # noqa: E402
from gn_ode_sir_tpu_torch.cli import infer, worker  # noqa: E402


def _scenarios(n_nodes: int, b: int, seed: int):
    rng = np.random.default_rng(seed)
    seeds = [sorted(rng.choice(n_nodes, 3, replace=False).tolist()) for _ in range(b)]
    return infer.scenario_batch(n_nodes, seeds, rng.uniform(0.1, 0.5, b),
                                rng.uniform(0.05, 0.3, b))


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "spmm2" in low:
        return "K1 spmm2"
    if "sir_step" in low:
        return "K2 sir_step"
    if "gemm" in low or "xmma" in low or "cutlass" in low or "matmul" in low:
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "reduce" in low or "softmax" in low:
        return "reduction/softmax"
    if "cat" in low or "index" in low or "gather" in low:
        return "copy/index"
    return "elementwise/other"


def summarize_profile(prof, wall_us: float) -> dict:
    """Device time of a ``torch.profiler`` trace by kernel group, the device's
    busy time (the union of its kernel spans) and idle share of ``wall_us``,
    K1's share of device time, and the twelve longest kernels."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        tot, cnt = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (tot + (end - start), cnt + 1)
    busy, last = 0.0, -1.0
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    groups = {}
    for name, (tot, _) in by_name.items():
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + tot
    device_total = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3 if spans else "not measured",
            "device_idle_share": 1 - busy / wall_us if spans else "not measured",
            "device_ms_by_group": {k: v / 1e3 for k, v in sorted(groups.items())},
            "k1_share_of_device_time": (groups.get("K1 spmm2", 0.0) / device_total
                                        if device_total else "not measured"),
            "top_kernels": [{"name": n[:90], "ms": t / 1e3, "count": c}
                            for n, (t, c) in top]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=[1, 8, 16])
    p.add_argument("--dispatches", type=int, default=40)
    p.add_argument("--out", default=None, help="also write the records to this JSON file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    records = [{"card": card}]
    print(json.dumps(records[0]), flush=True)

    g = powerlaw_graph(ENRON_NODES, ENRON_DIRECTED_EDGES, SEED)
    wargs = worker.build_parser().parse_args(
        ["--hidden", "64", "--spmm", "auto", "--device", "cuda"])
    for b in args.batches:
        model, adj = worker.build_model_and_adj(wargs, g, batch_size=b)
        params = model.init(torch.Generator().manual_seed(SEED), device="cuda")
        sb = _scenarios(g.n_nodes, b, SEED + b)
        for _ in range(2):
            infer.predict_summaries(model, params, adj, *sb)
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(args.dispatches):
            t0 = time.perf_counter()
            infer.predict_summaries(model, params, adj, *sb)
            walls.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(walls, n=4)
        rec = {"batch": b, "dispatches": len(walls), "ms_median": statistics.median(walls),
               "ms_p75": q[2], "ms_max": max(walls),
               "scenarios_per_s_at_median": b / statistics.median(walls) * 1e3,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        records.append(rec)
        print(json.dumps(rec), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            infer.predict_summaries(model, params, adj, *sb)
        wall_us = (time.perf_counter() - t0) * 1e6
    rec = {"profile_batch": args.batches[-1], "profiled_dispatches": 3,
           **summarize_profile(prof, wall_us)}
    records.append(rec)
    print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
