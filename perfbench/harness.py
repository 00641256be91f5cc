"""What every cell shares: the registry in ``BENCHMARK.json``, the files the
harness finds by name, the guard against JAX in the process, and the result
line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
PROGRAM = "gn_ode_sir_tpu_torch"
# top-level module names that may not be in the process that prints a result;
# compared whole, since the program's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "gn_ode_sir_tpu")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names of ``modules`` (default ``sys.modules``) that are
    in :data:`FORBIDDEN`, each compared as a whole string."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), interpreter start-up
    included."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


MARKS: list = []  # (phase, seconds since the process started) of the set-up


def mark(phase: str) -> None:
    """Note that a phase of the set-up has ended (printed on stderr)."""
    try:
        MARKS.append((phase, round(process_age_s(), 2)))
    except OSError:
        pass


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no cell {name!r} in BENCHMARK.json")


def load_workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def load_config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    key = f"perfbench._{kind}_{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` off its
    end-to-end metrics (one without ``workloads`` is every cell's), with it
    on the per-layer metrics whose ``workloads`` name it."""
    if not trace:
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def read_metrics(metrics: list[dict], run) -> dict:
    """Each metric's reader (``metrics/<name>.py``, ``read(run)``) on the run;
    a reader that finds nothing to read returns None and the metric is left
    out."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(run)
        if value is None:
            print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judged(checks: list[dict]) -> bool:
    """``correct``: every compared number finite and within its limit."""
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                 **({"compared": c["compared"]} if "compared" in c else {})}
                     for c in checks}
    return json.dumps(out)


def print_checks(checks: list[dict]) -> None:
    for c in checks:
        of = f" (compared: {c['compared']})" if "compared" in c else ""
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}{of}", file=sys.stderr)
    sys.stderr.flush()


class Clock:
    """Host clock of a window: ``start`` now, ``over`` once ``seconds``
    have passed."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def over(self) -> bool:
        return self.elapsed() >= self.seconds
