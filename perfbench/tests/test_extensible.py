"""A later change adds a configuration, a cell and a per-layer metric as new
files plus new entries in ``BENCHMARK.json``, and edits no existing file:
in a copy of the benchmark, such additions run."""

import json
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
