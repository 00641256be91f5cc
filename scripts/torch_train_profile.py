"""Label extraction rate, training step time and device-time breakdowns of the
PyTorch/CUDA port.

    python3 scripts/torch_train_profile.py [--sims 10000] [--trials 6] [--steps 20]

On one NVIDIA card, at the enron-size power-law graph of ``chip_smoke.py``
(n = 33,696, 361,000 directed edges):

- the count product I @ A at [sims x n]: time of each exact route
  (``torch._int_mm``, bf16 operands with f32 output), and K2 beside it;
- Monte-Carlo labels for ``--trials`` trials of ``--sims`` simulations, 20
  label times, through ``utils.load_or_extract_labels_many``: wall seconds
  and simulations per second, first call (which builds the dense adjacency)
  and a second call with other seeds, and a ``torch.profiler`` breakdown of
  one more call;
- C7 GN-ODE training (hidden 64, euler, deltaT 0.5, batch 1, Adam lr 1e-4)
  on those labels through the adjacency ``--spmm auto`` picks (K1): wall ms
  per step (forward, backward, optimiser step; median, 75th percentile, max
  over ``--steps`` steps, each ending in a synchronise) and a
  ``torch.profiler`` breakdown of five steps with K1's forward and backward
  launches, the device's idle share and peak memory.

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
import tempfile
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

from chip_smoke import (  # noqa: E402
    ENRON_DIRECTED_EDGES, ENRON_NODES, SEED, label_trials, powerlaw_graph, time_ms)
from gn_ode_sir_tpu_torch.cli import worker  # noqa: E402
from gn_ode_sir_tpu_torch.ops.spmm2 import spmm2  # noqa: E402
from gn_ode_sir_tpu_torch.sim import mc_sir  # noqa: E402
from gn_ode_sir_tpu_torch.sim.fused_step import sir_step  # noqa: E402
from gn_ode_sir_tpu_torch.train import build_trial_data, l1_sir_loss  # noqa: E402
from gn_ode_sir_tpu_torch.utils import load_or_extract_labels_many  # noqa: E402
from torch_serve_profile import summarize_profile  # noqa: E402

MAX_TIME = 20


def _profiled(fn, repeats: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return summarize_profile(prof, wall_us)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sims", type=int, default=10_000)
    p.add_argument("--trials", type=int, default=6)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default=None, help="also write the records to this JSON file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    emit({"card": card, "torch": torch.__version__})
    g = powerlaw_graph(ENRON_NODES, ENRON_DIRECTED_EDGES, SEED)
    n = g.n_nodes
    trials = label_trials(g)[:args.trials]

    # the count product and K2 at one trial's shape
    state = (torch.rand((args.sims, n), device=dev) < 0.05).to(torch.int8)
    rec = {"measure": "count_product", "rows": args.sims, "n": n,
           "auto": mc_sir.CUDA_AUTO_MATMUL}
    for route in ("int8", "bf16"):
        a = mc_sir.device_adjacency(g, route, dev)
        rec[route + "_ms"] = time_ms(lambda: mc_sir.count_product(state, a), 10, warmup=3)
    counts = mc_sir.count_product(state, mc_sir.device_adjacency(g, "bf16", dev))
    one = lambda v, dt: torch.tensor([v], dtype=dt, device=dev)
    rec["k2_ms"] = time_ms(lambda: sir_step(
        state, torch.zeros_like(state), counts, one(-0.3, torch.float32),
        one(6553.6, torch.float32), one(1, torch.int64), 1, sims=args.sims), 20)
    rec["column_sums_ms"] = time_ms(
        lambda: state.view(1, args.sims, n).sum(1, dtype=torch.float32), 20)
    emit(rec)
    del state, counts
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        def extract(name, seed0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = load_or_extract_labels_many(
                g, trials, sim=args.sims, max_time=MAX_TIME,
                save_dir=os.path.join(tmp, name),
                seeds=[seed0 + k for k in range(len(trials))], device=dev)
            return out, time.perf_counter() - t0

        for name, seed0 in (("first", 1000), ("second", 2000)):
            before = sir_step.launches
            triples, secs = extract(name, seed0)
            emit({"measure": "labels", "call": name, "trials": len(trials),
                  "sims": args.sims, "max_time": MAX_TIME, "seconds": secs,
                  "sims_per_s": len(trials) * args.sims / secs,
                  "k2_launches": sir_step.launches - before,
                  "count_product": mc_sir.CUDA_AUTO_MATMUL})
        emit({"measure": "labels_profile",
              **_profiled(lambda: extract("profiled", 3000), 1)})

    # training at batch 1 on the first trial's labels
    wargs = worker.build_parser().parse_args(
        ["--hidden", "64", "--spmm", "auto", "--batch_size", "1", "--device", "cuda"])
    model, adj = worker.build_model_and_adj(wargs, g)
    params = model.init(torch.Generator().manual_seed(SEED), device=dev)
    leaves = [t.requires_grad_(True) for v in params.values() for t in v.values()]
    opt = torch.optim.Adam(leaves, lr=1e-4)
    data = build_trial_data(n, [t[0] for t in trials], [t[1] for t in trials],
                            [t[2] for t in trials], triples)
    first = lambda a: torch.as_tensor(a[:1], device=dev)
    xs = tuple(first(a) for a in (data.s0, data.i0, data.r0, data.beta, data.gamma))
    labels, ones = first(data.labels), torch.ones(1, device=dev)

    def step():
        opt.zero_grad(set_to_none=True)
        l1_sir_loss(model.predict(params, adj, *xs), labels, trial_weight=ones).backward()
        opt.step()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    q = statistics.quantiles(walls, n=4)
    emit({"measure": "train_step", "batch": 1, "adjoint": model.adjoint,
          "adjacency": type(adj).__name__, "steps": len(walls),
          "ms_median": statistics.median(walls), "ms_p75": q[2], "ms_max": max(walls),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    fwd0, bwd0 = spmm2.launches, spmm2.backward_launches
    prof = _profiled(step, 5)
    emit({"measure": "train_profile", "profiled_steps": 5,
          "k1_launches": spmm2.launches - fwd0,
          "k1_backward_launches": spmm2.backward_launches - bwd0, **prof})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
