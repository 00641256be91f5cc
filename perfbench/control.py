"""The readings that set the limits of the output check, at a cell's own size.

    python3 perfbench/control.py --workload <cell> [--seeds 12] [--control-seeds 3]
        [--fault-seeds 3] [--seconds 2] [--out FILE]

In one process, on a CUDA card: the program's sound runs on ``--seeds``
seeds (set-up, a short window at the cell's own load, the check); the
control on ``--control-seeds`` seeds, which for a GN-ODE cell is the program
with TF32 on (its float32 products one precision below the configuration's)
and for a label cell the reference with bfloat16 coin thresholds put in the
program's place; and each fault the cell can have (``faults.py``) on
``--fault-seeds`` seeds. One JSON line per run, with every number compared
and the seconds the check took. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: import from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import faults, harness  # noqa: E402


def reading(cell: str, seed: int, seconds: float, *, kind: str = "sound", fault=None,
            device="cuda", workload=None, config=None) -> dict:
    """One run's compared numbers: ``kind`` 'sound', 'control' or 'fault'
    (``workload`` and ``config`` stand in for the cell's files)."""
    wl = workload or harness.load_workload(cell)
    cfg = copy.deepcopy(config or harness.load_config(wl["config"]))
    driver = harness.load_module("drivers", wl["driver"])
    tf32 = kind == "control" and wl["driver"] != "labels"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    extra = {"control": True} if kind == "control" and wl["driver"] == "labels" else {}
    detail = {}
    if wl["driver"] == "train":
        extra["detail"] = detail  # every recorded step's readings, for the look
    planted = faults.plant(wl["driver"], fault) if fault else contextlib.nullcontext()
    with planted:
        st = driver.setup(cfg, wl["traffic"], seed, device)
        rec = driver.window(st, seconds)
        t0 = time.perf_counter()
        checks = driver.check(st, rec, wl["check"], **extra)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"cell": cell, "kind": kind, "fault": fault, "seed": seed,
            "check_s": time.perf_counter() - t0, "attempted": driver.attempted(rec)[0],
            "correct": harness.judged(checks),
            "values": {c["name"]: c["value"] for c in checks},
            "compared": {c["name"]: c["compared"] for c in checks if "compared" in c},
            **({"detail": detail} if detail else {})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=2_200_000_000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    wl = harness.load_workload(args.workload)
    cfg = harness.load_config(wl["config"])
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    plan = [("sound", None, s) for s in seeds]
    plan += [("control", None, s) for s in seeds[:args.control_seeds]]
    plan += [("fault", f, s) for f in faults.applicable(wl["driver"], cfg)
             for s in seeds[:args.fault_seeds]]
    out = open(args.out, "a") if args.out else None
    rows = []
    for kind, fault, seed in plan:
        row = reading(args.workload, seed, args.seconds, kind=kind, fault=fault)
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
    names = list(rows[0]["values"])
    for kind in ("sound", "control", "fault"):
        got = [r for r in rows if r["kind"] == kind]
        if got:
            print(json.dumps({"summary": kind, **{
                n: [float(np.min([r["values"][n] for r in got])),
                    float(np.max([r["values"][n] for r in got]))] for n in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
