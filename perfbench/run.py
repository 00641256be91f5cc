"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (process start, CUDA context, the
program's kernels, inputs from the seed, the program's objects and the
warm-up of the cell's shapes) is timed as ``setup_s``; then the window runs
for ``--seconds``. With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` an untraced stretch of the same
length, then a short profiled stretch, give its per-layer metrics and the
``breakdown``. A cell with an end-to-end metric read from the device's trace
runs the profiled stretch after the window with ``--trace 0`` too. Either way, once the window has closed the plain reference
judges what the window's path produced, and every number compared is
printed beside its limit, last on standard error and last in the line.

Exits non-zero, printing no result, without as many CUDA cards as the cell
asks for, without the program beside the benchmark, or when JAX or the JAX
package was loaded into the process.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):  # run as a script: import from the checkout's root
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from perfbench import harness, profiling  # noqa: E402


def setup_seconds() -> float:
    try:
        return harness.process_age_s()
    except OSError:
        return time.perf_counter() - T_IMPORT


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", workload: dict | None = None, config: dict | None = None):
    """One run of cell ``name``: (result line as a dict, checks). ``device``
    'cpu' (tests at small sizes) skips the device's numbers."""
    wl = workload or harness.load_workload(name)
    cfg = config or harness.load_config(wl["config"])
    seed = int(seed) % 2**63  # any whole number; the generators take [0, 2^63)
    driver = harness.load_module("drivers", wl["driver"])
    on_card = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["model"].get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg["model"].get("tf32", False))
    torch.set_num_threads(1)
    harness.MARKS.clear()
    harness.mark("imports")
    state = driver.setup(cfg, wl["traffic"], seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = setup_seconds()
    print("setup: " + ", ".join(f"{k} {v} s" for k, v in harness.MARKS), file=sys.stderr)
    trace_data, traced = None, None
    rec = driver.window(state, seconds)
    # the profiled stretch runs where the line needs it: every per-layer run,
    # and an end-to-end run of a cell with a metric read from the device's trace
    if trace or any(m["source"] == "device_trace"
                    for m in harness.cell_metrics(bench, name, False)):
        traced, trace_data = (profiling.profiled(lambda: driver.traced(state)) if on_card
                              else (driver.traced(state), None))
    chips = harness.cell_entry(bench, name)["chips"]
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": chips,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0}
    if trace and trace_data is not None:
        device_info["busy_s"] = trace_data.busy_s()
        device_info["window_s"] = trace_data.wall_s
    run = types.SimpleNamespace(cell=name, cfg=cfg, traffic=wl["traffic"], setup_s=setup_s,
                                window=rec, traced=traced, trace=trace_data,
                                shapes=driver.shapes(state), on_card=on_card)
    checks = driver.check(state, rec, wl["check"])
    del state
    metrics = harness.read_metrics(harness.cell_metrics(bench, name, trace), run)
    attempted, failed = driver.attempted(rec)
    line = {"correct": harness.judged(checks) and failed == 0, "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": device_info, "checks": checks}
    if trace and trace_data is not None:
        line["breakdown"] = profiling.breakdown(trace_data)
    return line, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "perfbench-cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "perfbench-cache" / "ext"))
    if not (ROOT / harness.PROGRAM).is_dir():
        print(f"{harness.PROGRAM} is not beside the benchmark", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    chips = harness.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line, checks = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded into the process: {', '.join(found)}", file=sys.stderr)
        return 3
    harness.print_checks(checks)
    print(harness.result_line(line["correct"], line["attempted"], line["failed"],
                              line["metrics"], line["device"], checks, line.get("breakdown")),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
