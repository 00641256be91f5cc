"""The port stands alone: importing every module of gn_ode_sir_tpu_torch,
chip_smoke.py and the port's card scripts (scripts/torch_parallel_check.py,
scripts/torch_spmm2_tune.py) pulls in no JAX, nothing of gn_ode_sir_tpu, and
no networkx or pandas (absent on the machine with the card); every public name of the JAX package's subpackages exists in the
port's; and chip_smoke.py refuses to run,
printing no result, without a card or without the rest of the repository.
"""

import ast
import importlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import gn_ode_sir_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "scripts")
import torch_parallel_check, torch_spmm2_tune
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    return env


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_clean_env(),
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_imports(probe):
    expected = {"gn_ode_sir_tpu_torch.cli.infer", "gn_ode_sir_tpu_torch.cli.worker",
                "gn_ode_sir_tpu_torch.ops.spmm2", "gn_ode_sir_tpu_torch.ops._kernels",
                "gn_ode_sir_tpu_torch.models.gnode", "gn_ode_sir_tpu_torch.train.checkpoint",
                "gn_ode_sir_tpu_torch.sim.fused_step", "gn_ode_sir_tpu_torch.sim.mc_sir",
                "gn_ode_sir_tpu_torch.utils.labels", "gn_ode_sir_tpu_torch.utils.csvsink",
                "gn_ode_sir_tpu_torch.utils.config", "gn_ode_sir_tpu_torch.train.loss",
                "gn_ode_sir_tpu_torch.train.data", "gn_ode_sir_tpu_torch.train.loop",
                "gn_ode_sir_tpu_torch.graphs.batch", "gn_ode_sir_tpu_torch.sim.classical",
                "gn_ode_sir_tpu_torch.models.dmp", "gn_ode_sir_tpu_torch.models.gcn",
                "gn_ode_sir_tpu_torch.models.gin", "gn_ode_sir_tpu_torch.models.adapter",
                "gn_ode_sir_tpu_torch.train.multigraph",
                "gn_ode_sir_tpu_torch.odeint.adjoint", "gn_ode_sir_tpu_torch.odeint.dopri",
                "gn_ode_sir_tpu_torch.train.ensemble", "gn_ode_sir_tpu_torch.train.node_split",
                "gn_ode_sir_tpu_torch.cli.monitorer",
                "gn_ode_sir_tpu_torch.utils.timing", "gn_ode_sir_tpu_torch.utils.profiling",
                "gn_ode_sir_tpu_torch.utils.roofline", "gn_ode_sir_tpu_torch.ops.ell",
                "gn_ode_sir_tpu_torch.native", "gn_ode_sir_tpu_torch.parallel",
                "gn_ode_sir_tpu_torch.parallel.distributed", "gn_ode_sir_tpu_torch.parallel.mesh",
                "gn_ode_sir_tpu_torch.parallel.sim", "gn_ode_sir_tpu_torch.parallel.spmd"}
    assert expected <= set(probe["modules"])


SUBPACKAGES = ("graphs", "models", "odeint", "ops", "parallel", "sim", "train", "utils")


def _jax_all(sub: str) -> list:
    """``__all__`` of ``gn_ode_sir_tpu/<sub>/__init__.py``, read from its
    source (importing it would pull in JAX)."""
    with open(os.path.join(REPO, "gn_ode_sir_tpu", sub, "__init__.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"gn_ode_sir_tpu/{sub}/__init__.py has no __all__")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_public_name_of_the_jax_subpackage_exists(sub):
    port = importlib.import_module(f"gn_ode_sir_tpu_torch.{sub}")
    names = _jax_all(sub)
    assert names
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"gn_ode_sir_tpu_torch.{sub} lacks {missing}"
    assert set(names) <= set(port.__all__)


@pytest.mark.parametrize("module,name", [
    ("gn_ode_sir_tpu_torch.odeint.resample", "resample_expected_counts"),
    ("gn_ode_sir_tpu_torch.odeint", "resample_expected_counts"),
    ("gn_ode_sir_tpu_torch.ops.spmm", "spmm"),
    ("gn_ode_sir_tpu_torch.ops", "spmm"),
    ("gn_ode_sir_tpu_torch.graphs.load", "GRAPH_STEM"),
    ("gn_ode_sir_tpu_torch.graphs", "GRAPH_STEM"),
])
def test_names_of_ported_modules(module, name):
    assert hasattr(importlib.import_module(module), name)


@pytest.mark.parametrize("forbidden", ["jax", "jaxlib", "gn_ode_sir_tpu", "optax",
                                       "orbax", "networkx", "pandas", "triton"])
def test_no_forbidden_module_loaded(probe, forbidden):
    bad = [m for m in probe["loaded"] if m == forbidden or m.startswith(forbidden + ".")]
    assert not bad, f"importing the port loaded {bad[:5]}"


def test_new_tensor_placing_calls_need_an_explicit_device():
    """Nothing the multi-graph and baseline modules add picks a device for the
    caller: without ``device`` each refuses to run."""
    import numpy as np

    from gn_ode_sir_tpu_torch.graphs import graph_from_edges, pad_graphs
    from gn_ode_sir_tpu_torch.models import DMPSIR, GCN, GIN, TimeUnrolledSIR
    from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_batch
    from gn_ode_sir_tpu_torch.ops.spmm2 import Spmm2Adj
    from gn_ode_sir_tpu_torch.sim import sir_classical, sir_classical_batch
    from gn_ode_sir_tpu_torch.train import (assemble_multigraph_trials, multigraph_adj_fns,
                                            multigraph_auto_fns, multigraph_pallas2_fns)

    ga = graph_from_edges(6, [(k, (k + 1) % 6) for k in range(6)], name="a")
    gb = graph_from_edges(9, [(0, k) for k in range(1, 9)], name="b")
    batch = pad_graphs([ga, gb])
    dmp = DMPSIR.from_graph(ga)
    trials = [[([1], 0.3, 0.1)], [([2], 0.2, 0.2), ([3], 0.4, 0.1)]]
    calls = [
        lambda **kw: multigraph_auto_fns(batch, **kw),
        lambda **kw: multigraph_adj_fns(batch, kind="dense", **kw),
        lambda **kw: multigraph_pallas2_fns(batch, **kw),
        lambda **kw: assemble_multigraph_trials([ga, gb], trials, sim=20, max_time=3, **kw),
        lambda **kw: sir_classical_batch(ga, [[1]], [0.3], [0.1], max_time=3, **kw),
        lambda **kw: sir_classical(ga, [1], 0.3, 0.1, max_time=3, **kw),
        lambda **kw: dmp.run([1], 0.3, 0.1, max_time=3, **kw),
        lambda **kw: dmp.run_many([[1], [2]], [0.3, 0.2], [0.1, 0.2], max_time=3, **kw),
        lambda **kw: GCN(window=3).init(torch.Generator(), **kw),
        lambda **kw: GIN(window=3).init(torch.Generator(), **kw),
        lambda **kw: TimeUnrolledSIR(GCN(window=3)).init(torch.Generator(), **kw),
        lambda **kw: adjacency_from_batch(batch, np.array([0, 1]), **kw),
        lambda **kw: Spmm2Adj.from_edges(ga.src, ga.dst, 8, **kw),
    ]
    from gn_ode_sir_tpu_torch.models import GNODE
    from gn_ode_sir_tpu_torch.train import init_ensemble

    calls.append(lambda **kw: init_ensemble(GNODE(hidden=4), [0, 1], **kw))
    for call in calls:
        with pytest.raises(TypeError, match="device"):
            call()
        call(device="cpu")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=_clean_env(),
                          capture_output=True, text=True, timeout=300)


def _assert_no_result(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: chip_smoke.py would run for real")
    _assert_no_result(_run_smoke(REPO))


def test_chip_smoke_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = _clean_env()
    env["PYTHONPATH"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    _assert_no_result(proc)
