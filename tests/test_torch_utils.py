"""Port parity: ``gn_ode_sir_tpu_torch.utils`` timing, profiling and roofline
against ``gn_ode_sir_tpu.utils``.

The roofline models must give the JAX package's ``ops`` and ``bytes`` at the
same arguments (exactly: the same float64 arithmetic), and score against the
H100 peaks; the logger writes the JAX package's JSONL; ``trace`` and
``fit(profile_dir=)`` leave a profiler trace; ``device_memory_stats`` is
empty on the CPU.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.utils import MetricsLogger as JaxMetricsLogger
from gn_ode_sir_tpu.utils import roofline as jax_roofline
from gn_ode_sir_tpu_torch.utils import MetricsLogger, Timer, device_memory_stats, trace
from gn_ode_sir_tpu_torch.utils import roofline
from gn_ode_sir_tpu_torch.utils.timing import block_until_ready, timed

torch.set_num_threads(1)

# the shapes of tests/test_utils.py::test_roofline_models
MODEL_CASES = [
    ("mc_sim_model", dict(n_nodes=2905, sims=10_000, max_time=20), "int8_ops"),
    ("mc_sim_model", dict(n_nodes=33_696, sims=60_000, max_time=20, state_bytes=4), "int8_ops"),
    ("gnode_train_epoch_model", dict(n_nodes=7066, hidden=64, batch=1, steps_per_epoch=120,
                                     n_solver_steps=40), "f32_flops"),
    ("spmm_apply_model", dict(n_nodes=7066, n_directed_edges=201_472, hidden=64), "f32_flops"),
    ("spmm_apply_model", dict(n_nodes=33_696, n_directed_edges=361_000, hidden=64,
                              msg_bytes=2), "f32_flops"),
    ("mg_train_epoch_model", dict(n_max=33696, hidden=8, batch=8,
                                  steps_edges=[(5, 361_622), (18, 40_000)],
                                  n_solver_steps=40), "f32_flops"),
    ("mg_train_epoch_model", dict(n_max=33696, hidden=8, batch=8,
                                  steps_edges=[(6, 361_622), (18, 40_000)],
                                  n_solver_steps=40, msg_bytes=2), "f32_flops"),
]


@pytest.mark.parametrize("name,kwargs,peak_key", MODEL_CASES)
def test_roofline_model_equals_jax(name, kwargs, peak_key):
    got = getattr(roofline, name)(**kwargs)
    want = getattr(jax_roofline, name)(**kwargs)
    assert got["ops"] == want["ops"] and got["bytes"] == want["bytes"]
    # the port scores against the rate its path runs at (f32 with TF32 off,
    # or the int8 count product)
    assert got["peak_key"] == peak_key and peak_key in roofline.H100_PEAKS


def test_h100_peaks():
    p = roofline.H100_PEAKS
    assert p["name"] == "NVIDIA H100 80GB HBM3 (SXM5, 700 W)"
    assert (p["f32_flops"], p["tf32_flops"], p["bf16_flops"], p["int8_ops"],
            p["hbm_bytes_per_s"]) == (67e12, 494.7e12, 989.4e12, 1979e12, 3.35e12)


def test_utilization_arithmetic():
    m = {"ops": 6.7e12, "bytes": 3.35e12, "peak_key": "f32_flops"}
    u = roofline.utilization(m, wall_s=2.0)
    assert u["modeled_tops"] == pytest.approx(6.7)
    assert u["modeled_gb"] == pytest.approx(3350.0)
    assert u["achieved_tops"] == pytest.approx(3.35)
    assert u["mfu"] == pytest.approx(0.05)
    assert u["achieved_gbps"] == pytest.approx(1675.0)
    assert u["hbm_frac"] == pytest.approx(0.5)
    assert u["peaks_for"] == roofline.H100_PEAKS["name"]
    # the same arithmetic as the JAX package's under the same peaks
    want = jax_roofline.utilization(m, 2.0, peaks=roofline.H100_PEAKS)
    assert u == want


def test_metrics_logger_round_trip_matches_jax(tmp_path):
    ours, theirs = tmp_path / "port" / "m.jsonl", tmp_path / "jax" / "m.jsonl"
    for cls, path in ((MetricsLogger, ours), (JaxMetricsLogger, theirs)):
        ml = cls(str(path))
        assert ml.read() == []
        ml.log(epoch=0, loss=1.5, wall_s=0.25)
        ml.log(epoch=1, loss=np.float32(1.25))
    assert ours.read_text().splitlines()[0] == theirs.read_text().splitlines()[0]
    rows = MetricsLogger(str(ours)).read()
    assert [r["epoch"] for r in rows] == [0, 1] and rows[1]["loss"] == 1.25
    assert "wall_s" in rows[1]
    assert [json.loads(x) for x in theirs.read_text().splitlines()][1].keys() == rows[1].keys()


def test_timer_and_timed():
    x = torch.ones(64, 64)
    with Timer() as t:
        y = t.block_on(x @ x)
    assert t.seconds > 0.0 and float(y[0, 0]) == 64.0
    out, secs = timed(lambda a: {"y": [a @ a, None]}, x)
    assert secs > 0.0 and float(out["y"][0][0, 0]) == 64.0
    with Timer() as t2:
        pass
    assert t2.seconds >= 0.0
    # nothing to wait for on the CPU, and non-tensor leaves pass through
    tree = {"a": (x, 3), "b": [x]}
    assert block_until_ready(tree) is tree


def test_trace_writes_a_file(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d) as got:
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    assert got == d
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert files and os.path.getsize(files[0]) > 0


def test_device_memory_stats_is_empty_on_the_cpu():
    assert device_memory_stats("cpu") == {}
    assert device_memory_stats(torch.device("cpu")) == {}


def test_fit_profile_dir_traces_the_epoch_range(tmp_path):
    from gn_ode_sir_tpu_torch.graphs import graph_from_edges
    from gn_ode_sir_tpu_torch.models import GNODE
    from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
    from gn_ode_sir_tpu_torch.train import build_trial_data, fit

    rng = np.random.default_rng(0)
    g = graph_from_edges(12, [(k, (k + 1) % 12) for k in range(12)] + [(0, 6), (3, 9)])
    n_trials, max_time = 4, 4
    nodes = [[int(rng.integers(12))] for _ in range(n_trials)]
    triples = []
    for _ in range(n_trials):
        p = rng.dirichlet([2.0, 1.0, 1.0], size=(max_time, 12))
        triples.append((p[..., 0], p[..., 1], p[..., 2]))
    data = build_trial_data(12, nodes, rng.uniform(0.1, 0.5, n_trials),
                            rng.uniform(0.1, 0.4, n_trials), triples)
    model = GNODE(hidden=4, max_time=max_time)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    adj = adjacency_from_graph(g, kind="dense", device="cpu")
    common = dict(epochs=4, batch_size=2, seed=1, verbose=False)
    opt = lambda leaves: torch.optim.Adam(leaves, lr=1e-2)
    d = str(tmp_path / "prof")
    res = fit(model, opt, params, data, [0, 1], [2], [3], lambda gi: adj, profile_dir=d,
              profile_epochs=(1, 2), **common)
    assert glob.glob(os.path.join(d, "*.pt.trace.json"))
    # profiling changes nothing in the run
    ref = fit(model, opt, params, data, [0, 1], [2], [3], lambda gi: adj, **common)
    assert res.history == ref.history
