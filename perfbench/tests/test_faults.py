"""Each cell at a small size on the CPU: a sound run comes out correct, and
the rest of a run with the timed path broken underneath (each fault the
cell can have) comes out not correct; so does the label cell's control."""

import contextlib

import pytest
import torch

from perfbench import faults, harness
from perfbench.run import run_cell
from perfbench.tests import small

torch.set_num_threads(1)
BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]


def _cases(cell: str) -> list:
    wl, cfg = small.cell(cell)
    return [(cell, f) for f in (None, *faults.applicable(wl["driver"], cfg, wl["traffic"]))]


CASES = [case for c in CELLS for case in _cases(c)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_incorrect(cell, fault):
    wl, cfg = small.cell(cell)
    with faults.plant(wl["driver"], fault) if fault else contextlib.nullcontext():
        line, _ = run_cell(BENCH, cell, small.SEED, 0.3, False, device="cpu", workload=wl,
                           config=cfg)
    assert line["correct"] is (fault is None), line["checks"]


def _driver(cell: str):
    return harness.load_module("drivers", harness.load_workload(cell)["driver"])


SERVING = [c for c in CELLS if "dispatch_batch" in harness.load_workload(c)["traffic"]]


@pytest.mark.parametrize("cell", [c for c in SERVING if "half_batch" in _driver(c).FAULTS])
def test_half_batch_needs_two_scenarios_a_dispatch(cell):
    """A dispatch of one scenario has no half to leave out: a serving cell of
    one scenario a request, or a dispatch, cannot have ``half_batch``."""
    wl, cfg = small.cell(cell)
    module = harness.load_module("drivers", wl["driver"])
    for per_request, per_dispatch, has in ((8, 8, True), (1, 8, False), (8, 1, False)):
        traffic = {**wl["traffic"], "scenarios_per_request": per_request,
                   "dispatch_batch": per_dispatch}
        got = faults.applicable(wl["driver"], cfg, traffic)
        assert ("half_batch" in got) is has
        assert set(got) | {"half_batch"} == set(module.FAULTS)


def test_label_control_is_incorrect():
    wl, cfg = small.cell("c7_enron.labels")
    driver = harness.load_module("drivers", wl["driver"])
    around, extra = driver.control_run("control")
    with around:
        st = driver.setup(cfg, wl["traffic"], small.SEED, "cpu")
        rec = driver.window(st, 0.2)
        assert not harness.judged(driver.check(st, rec, wl["check"], **extra))


@pytest.mark.parametrize("cell", [c for c in CELLS if hasattr(_driver(c), "RECORDED")])
def test_training_check_with_nothing_recorded_is_incorrect(cell):
    """A window whose steps left no readings (the optimiser's hooks silent)
    reads inf, not 0."""
    wl, cfg = small.cell(cell)
    driver = _driver(cell)
    st = driver.setup(cfg, wl["traffic"], small.SEED, "cpu")
    rec = driver.window(st, 0.2)
    setattr(st, driver.RECORDED, [])
    checks = driver.check(st, rec, wl["check"])
    assert all(c["value"] == float("inf") for c in checks) and not harness.judged(checks)


@pytest.mark.parametrize("cell", SERVING)
def test_serving_check_with_a_summary_not_a_number_is_incorrect(cell):
    """A summary that is not a number anywhere in the sample reads inf in
    every number compared: not the quantile, which one scenario cannot move,
    nor a widest gap, which a comparison with NaN would pass over."""
    wl, cfg = small.cell(cell)
    driver = harness.load_module("drivers", wl["driver"])
    st = driver.setup(cfg, wl["traffic"], small.SEED, "cpu")
    rec = driver.window(st, 0.2)
    for _, summaries in st.sent:
        summaries[0, 0] = float("nan")  # a peak infected fraction
    checks = driver.check(st, rec, wl["check"])
    assert all(c["value"] == float("inf") for c in checks) and not harness.judged(checks)
