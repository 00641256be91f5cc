"""The command's edges: the JAX guard, the result line, and the refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness

ROOT = harness.ROOT


def test_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(["gn_ode_sir_tpu_torch", "gn_ode_sir_tpu_torch.ops",
                                      "jaxtyping", "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert harness.forbidden_modules(["gn_ode_sir_tpu.models.gnode"]) == ["gn_ode_sir_tpu"]
    assert harness.forbidden_modules(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]


def test_result_line_keys():
    checks = [{"name": "loss_gap", "value": 1e-7, "limit": 1e-5}]
    line = json.loads(harness.result_line(True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                                          {"platform": "gpu", "kind": "x", "count": 1,
                                           "memory_peak_bytes": 5}, checks))
    assert list(line) == [*harness.RESULT_KEYS, "checks"]
    traced = json.loads(harness.result_line(False, 1, 1, {}, {}, checks,
                                            {"device_ops": [], "idle_gaps": []}))
    assert list(traced) == [*harness.RESULT_KEYS, "breakdown", "checks"]
    assert traced["checks"]["loss_gap"] == {"value": 1e-7, "limit": 1e-5}


def test_judged():
    ok = {"name": "a", "value": 1.0, "limit": 2.0}
    assert harness.judged([ok])
    assert not harness.judged([ok, {"name": "b", "value": 3.0, "limit": 2.0}])
    assert not harness.judged([{"name": "b", "value": float("nan"), "limit": 2.0}])
    assert not harness.judged([])


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mg_h8.train_b8",
                           "--seed", "4000000001", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this test is of the refusal without one")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_multigraph_trace_holds_whole_epochs():
    """After the window the multi-graph cell finishes its epoch untimed, so
    the profiled stretch is one whole epoch: each graph's rows, every seed."""
    from perfbench.tests import small

    wl, cfg = small.cell("mg_h8.train_b8")
    driver = harness.load_module("drivers", wl["driver"])
    seen = []
    for seed in (small.SEED, small.SEED + 1):
        st = driver.setup(cfg, wl["traffic"], seed, "cpu")
        driver.window(st, 0.01)
        assert st.pos == len(st.rows)
        wl["traffic"]["trace_steps"] = len(st.rows)
        rec = driver.traced(st)
        seen.append(sorted(g for g, _ in rec["units"]))
    assert seen[0] == seen[1] and len(set(seen[0])) == 2
