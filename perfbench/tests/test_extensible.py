"""A later change adds a configuration, a cell and a per-layer metric as new
files plus new entries in ``BENCHMARK.json``, and edits no existing file:
in a copy of the benchmark, such additions run. So does a new driver, with
its own faults, control and CPU cut: the registry's test, the fault walk and
``control.reading`` take it as they take the drivers there are."""

import json
import os
import shutil
import subprocess
import sys

from perfbench import harness

NEW_CONFIG = {
    "name": "gnode_tiny", "source": "a test", "reference": "gnode",
    "model": {"family": "GN-ODE C7", "hidden": 4, "method": "euler", "delta_t": 0.5,
              "max_time": 6, "activation": "sigmoid", "encode_r": True, "dtype": "f32",
              "tf32": False, "spmm": "pallas2", "mg_adj": "pallas2", "adjacency": "K1"},
    "training": {"lr": 0.001, "batch_size": 2, "n_i": 2, "beta": [0.1, 0.5],
                 "gamma": [0.1, 0.5]},
    "graphs": [{"name": "x", "nodes": 20, "directed_edges": 60, "role": "train"},
               {"name": "y", "nodes": 24, "directed_edges": 70, "role": "unseen"}],
    "reduced": [],
}
NEW_CELL = {"config": "gnode_tiny", "driver": "train",
            "traffic": {"trials_per_graph": 4, "steps_per_call": 2, "first_steps": 1,
                        "check_call_within": 2,
                        "trace_steps": 2},
            "check": {"loss_gap": 1e-5, "grad_gap": 1e-4, "adam_gap": 1e-4}}
NEW_METRIC = '''"""Steps of the traced stretch."""


def read(run):
    return run.traced["steps"] if run.traced else None
'''


def test_new_files_and_entries_run(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    (tmp_path / "perfbench/configs/gnode_tiny.json").write_text(json.dumps(NEW_CONFIG))
    (tmp_path / "perfbench/workloads/tiny.train_b2.json").write_text(json.dumps(NEW_CELL))
    (tmp_path / "perfbench/metrics/steps_traced.train.py").write_text(NEW_METRIC)
    bench = harness.load_benchmark()
    bench["configs"].append({"name": "gnode_tiny", "source": "a test",
                             "file": "perfbench/configs/gnode_tiny.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny.train_b2", "config": "gnode_tiny",
                               "traffic": "train_b2", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_device_ms":
            m["workloads"].append("tiny.train_b2")
    for m in bench["per_layer"]:
        if m["name"] == "train_wall_ms":
            m["workloads"].append("tiny.train_b2")
    bench["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train/loop.py host path",
                               "moves": "train_device_ms", "workloads": ["tiny.train_b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys, json; sys.path[:0] = [{str(tmp_path)!r}];"
            f"from perfbench import harness; from perfbench.run import run_cell;"
            f"b = harness.load_benchmark();"
            f"print(json.dumps([run_cell(b, 'tiny.train_b2', 7, 0.2, t, device='cpu')[0]"
            f" for t in (False, True)]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PYTHONPATH": str(harness.ROOT),
                                                       "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    # on the CPU there is no device trace: train_device_ms finds nothing to read
    assert plain["correct"] and set(plain["metrics"]) == {"setup_s"}
    assert traced["metrics"]["steps_traced.train"]["value"] == 2
    assert traced["metrics"]["train_wall_ms"]["value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items()), "an existing file changed"


NEW_DRIVER = '''"""DMP serving through the DMP driver's request loop, with faults, a
control and a CPU cut of its own."""

import contextlib

import torch

from perfbench import faults, harness

_loop = harness.load_module("drivers", "serve_dmp")
setup, window, traced, shapes, check, attempted = (
    _loop.setup, _loop.window, _loop.traced, _loop.shapes, _loop.check, _loop.attempted)

FAULTS = ("marginals_held",)


def _on_k5(after):
    from gn_ode_sir_tpu_torch.models import dmp

    k5 = dmp.dmp_marginals

    def step(out, prev, *rest):
        k5(out, prev, *rest)
        after(out, prev)

    return faults._patched(dmp, "dmp_marginals", step)


def plant(fault):
    if fault == "marginals_held":
        return _on_k5(lambda out, prev: out.copy_(prev))
    raise ValueError(fault)


def control_run(kind):
    if kind != "control":
        return contextlib.nullcontext(), {}
    return _on_k5(lambda out, prev: out.copy_(out.bfloat16())), {}


def cpu_cut(wl, cfg):
    wl["traffic"].update(check_requests=3)
'''
NEW_DMP_CONFIG = {
    "name": "dmp_tiny", "source": "a test", "reference": "dmp",
    "model": {"family": "DMP", "max_time": 8, "dtype": "f32", "tf32": False},
    "scenarios": {"n_i": 2, "beta": [0.1, 0.5], "gamma": [0.1, 0.5]},
    "graphs": [{"name": "t", "nodes": 500, "directed_edges": 2000, "role": "serve"}],
    "reduced": [],
}
NEW_DMP_CELL = {"config": "dmp_tiny", "driver": "tiny_dmp",
                "traffic": {"scenarios_per_request": 4, "dispatch_batch": 4,
                            "warmup_requests": 1, "trace_requests": 2, "check_requests": 50},
                "check": {"dmp_summary_gap": 1e-4}}
NEW_DMP_METRIC = '''"""Requests of the traced stretch."""


def read(run):
    return run.traced["requests"] if run.traced else None
'''
READINGS = """
import json
from perfbench import control, faults, harness
from perfbench.tests import small
wl, cfg = small.cell("tiny.serve_b4")
rows = [control.reading("tiny.serve_b4", 11, 0.2, kind=k, fault=f, device="cpu", workload=wl,
                        config=cfg)
        for k, f in [("sound", None), ("control", None),
                     *(("fault", f) for f in faults.applicable(wl["driver"], cfg, wl["traffic"]))]]
print(json.dumps([[r["kind"], r["fault"], r["correct"], r["values"]] for r in rows]))
"""


def test_new_driver_runs_through_the_tests_and_the_readings(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    (tmp_path / "perfbench/drivers/tiny_dmp.py").write_text(NEW_DRIVER)
    (tmp_path / "perfbench/configs/dmp_tiny.json").write_text(json.dumps(NEW_DMP_CONFIG))
    (tmp_path / "perfbench/workloads/tiny.serve_b4.json").write_text(json.dumps(NEW_DMP_CELL))
    (tmp_path / "perfbench/metrics/requests_traced.serve.py").write_text(NEW_DMP_METRIC)
    bench = harness.load_benchmark()
    bench["configs"].append({"name": "dmp_tiny", "source": "a test",
                             "file": "perfbench/configs/dmp_tiny.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny.serve_b4", "config": "dmp_tiny",
                               "traffic": "serve_b4", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_scenarios_per_s":
            m["workloads"].append("tiny.serve_b4")
    bench["per_layer"].append({"name": "requests_traced.serve", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "cli/infer.py dispatch", "moves": "serve_scenarios_per_s",
                               "workloads": ["tiny.serve_b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {"PYTHONPATH": os.pathsep.join([str(tmp_path), str(harness.ROOT)]),
           "PATH": "/usr/bin:/bin"}
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "perfbench/tests/test_registry.py", "perfbench/tests/test_faults.py",
         "-k", "tiny or contract_shape or every_metric_file_is_listed"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert tests.returncode == 0, tests.stdout[-3000:] + tests.stderr[-3000:]
    # the registry's cell test, the contract, the metric files, the walk's
    # sound run and its one fault, the serving check of a summary not a number
    assert "6 passed" in tests.stdout, tests.stdout[-3000:]
    out = subprocess.run([sys.executable, "-c", READINGS], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    assert [r[:3] for r in rows] == [["sound", None, True], ["control", None, False],
                                     ["fault", "marginals_held", False]], rows
    assert all(p.read_bytes() == b for p, b in before.items()), "an existing file changed"
