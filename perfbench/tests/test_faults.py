"""Each cell at a small size on the CPU: a sound run comes out correct, and
the rest of a run with the timed path broken underneath (each fault the
cell can have) comes out not correct; so does the label cell's control."""

import pytest
import torch

from perfbench import faults, harness
from perfbench.run import run_cell
from perfbench.tests import small

torch.set_num_threads(1)
BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
CASES = [(c, f) for c in CELLS
         for f in (None, *faults.applicable(harness.load_workload(c)["driver"], small.cell(c)[1]))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(cell, fault):
    wl, cfg = small.cell(cell)
    planted = faults.plant(wl["driver"], fault) if fault else None
    if planted:
        with planted:
            line, _ = run_cell(BENCH, cell, small.SEED, 0.3, False, device="cpu", workload=wl,
                               config=cfg)
    else:
        line, _ = run_cell(BENCH, cell, small.SEED, 0.3, False, device="cpu", workload=wl,
                           config=cfg)
    assert line["correct"] is (fault is None), line["checks"]


def test_label_control_is_incorrect():
    wl, cfg = small.cell("c7_enron.labels")
    driver = harness.load_module("drivers", "labels")
    st = driver.setup(cfg, wl["traffic"], small.SEED, "cpu")
    rec = driver.window(st, 0.2)
    assert not harness.judged(driver.check(st, rec, wl["check"], control=True))


@pytest.mark.parametrize("cell", [c for c in CELLS if harness.load_workload(c)["driver"] == "train"])
def test_training_check_with_nothing_recorded_is_incorrect(cell):
    """A window whose steps left no readings (the optimiser's hooks silent)
    reads inf, not 0."""
    wl, cfg = small.cell(cell)
    driver = harness.load_module("drivers", "train")
    st = driver.setup(cfg, wl["traffic"], small.SEED, "cpu")
    rec = driver.window(st, 0.2)
    st.recorded = []
    checks = driver.check(st, rec, wl["check"])
    assert all(c["value"] == float("inf") for c in checks) and not harness.judged(checks)
