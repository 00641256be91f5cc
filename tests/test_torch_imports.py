"""The port stands alone: importing every module of gn_ode_sir_tpu_torch,
chip_smoke.py and the port's profiling scripts pulls in no JAX, nothing of
gn_ode_sir_tpu, and no networkx or pandas (absent on the machine with the
card); and chip_smoke.py refuses to run,
printing no result, without a card or without the rest of the repository.
"""

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
import torch_serve_profile, torch_train_profile
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
                "gn_ode_sir_tpu_torch.train.data", "gn_ode_sir_tpu_torch.train.loop"}
    assert expected <= set(probe["modules"])


@pytest.mark.parametrize("forbidden", ["jax", "jaxlib", "gn_ode_sir_tpu", "optax",
                                       "orbax", "networkx", "pandas", "triton"])
def test_no_forbidden_module_loaded(probe, forbidden):
    bad = [m for m in probe["loaded"] if m == forbidden or m.startswith(forbidden + ".")]
    assert not bad, f"importing the port loaded {bad[:5]}"


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
