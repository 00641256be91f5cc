"""The readings that set the limit of the DMP cells' output check, at a
cell's own size, and the faults and control they are set against.

    python3 perfbench/control_dmp.py --workload dmp_enron.serve_b128 [--seeds 12]
        [--control-seeds 3] [--fault-seeds 3] [--seconds 2] [--out FILE]

In one process, on a CUDA card, as ``control.py`` does for the other cells:
the program's sound runs on ``--seeds`` seeds; the control on
``--control-seeds`` seeds: the recursion's edge state (theta, phi, Ps_ij)
held in bfloat16 between steps, one precision below the configuration's
float32; and each fault on ``--fault-seeds`` seeds. One JSON line per run.
The benchmark's own runs do not run this.

Faults, planted in memory in the program underneath the harness:
- ``state_unchanged``: theta held at its value before the first step;
- ``half_batch``: a dispatch scores the first half of its scenarios and
  repeats them (``faults.py``'s serving fault);
- ``answer_altered``: the final recovered fraction read one time early
  (``faults.py``'s serving fault);
- ``backtracking``: the cavity term left out, Ps_ij from the node's full
  product.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script: import from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import control, faults, harness  # noqa: E402

DRIVER = "serve_dmp"
FAULTS = ("state_unchanged", "half_batch", "answer_altered", "backtracking")


def plant(fault: str):
    """The context manager that plants ``fault`` in the DMP serving path."""
    from gn_ode_sir_tpu_torch.models import dmp

    if fault == "state_unchanged":
        orig = dmp._step

        def held(theta, *a, **k):
            _, *rest = orig(theta, *a, **k)
            return (theta, *rest)

        return faults._patched(dmp, "_step", held)
    if fault in ("half_batch", "answer_altered"):
        return faults.plant("serve", fault)
    if fault == "backtracking":
        return faults._patched(dmp, "_cavity", lambda theta, edges: torch.ones_like(theta))
    raise ValueError(f"unknown fault {fault!r}")


def bfloat16_edge_state():
    """The control: theta, phi and Ps_ij rounded to bfloat16 after every
    step, so that each step starts from edge state held in bfloat16."""
    from gn_ode_sir_tpu_torch.models import dmp

    orig = dmp._step
    low = lambda x: x.to(torch.bfloat16).to(x.dtype)

    def rounded(*a, **k):
        theta, phi, ps_ij, marg = orig(*a, **k)
        return low(theta), low(phi), low(ps_ij), marg

    return faults._patched(dmp, "_step", rounded)


def reading(cell: str, seed: int, seconds: float, *, kind: str = "sound", fault=None,
            device="cuda", workload=None, config=None) -> dict:
    """One run's compared numbers: ``kind`` 'sound', 'control' or 'fault'."""
    wl = workload or harness.load_workload(cell)
    cfg = config or harness.load_config(wl["config"])
    driver = harness.load_module("drivers", wl["driver"])
    planted = (plant(fault) if fault else bfloat16_edge_state() if kind == "control"
               else contextlib.nullcontext())
    with planted:
        st = driver.setup(cfg, wl["traffic"], seed, device)
        rec = driver.window(st, seconds)
        t0 = time.perf_counter()
        checks = driver.check(st, rec, wl["check"])
    return {"cell": cell, "kind": kind, "fault": fault, "seed": seed,
            "check_s": time.perf_counter() - t0, "attempted": driver.attempted(rec)[0],
            "correct": harness.judged(checks),
            "values": {c["name"]: c["value"] for c in checks}}


def register() -> None:
    """Let ``faults.py``'s table and ``control.reading``, which know the
    drivers they were written with, reach this driver's faults and control,
    for the harness's tests that walk every cell."""
    if DRIVER in faults.BY_DRIVER:
        return
    faults.BY_DRIVER[DRIVER] = FAULTS
    plant_any, read_any = faults.plant, control.reading

    def plant_by_driver(driver, fault):
        return plant(fault) if driver == DRIVER else plant_any(driver, fault)

    def reading_by_driver(cell, *a, workload=None, **k):
        wl = workload or harness.load_workload(cell)
        read = reading if wl["driver"] == DRIVER else read_any
        return read(cell, *a, workload=wl, **k)

    faults.plant, control.reading = plant_by_driver, reading_by_driver


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=2_300_000_000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    plan = [("sound", None, s) for s in seeds]
    plan += [("control", None, s) for s in seeds[:args.control_seeds]]
    plan += [("fault", f, s) for f in FAULTS for s in seeds[:args.fault_seeds]]
    rows = []
    with open(args.out, "a") if args.out else contextlib.nullcontext() as out:
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
        print(json.dumps({"summary": kind, **{
            n: [float(np.min([r["values"][n] for r in got])),
                float(np.max([r["values"][n] for r in got]))] for n in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
