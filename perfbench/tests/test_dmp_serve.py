"""The DMP serving cell at a small size on the CPU (``small.py``'s cut),
through ``control.reading``: a sound run's check passes; the control (edge
state held in bfloat16) and every fault of the driver's ``FAULTS`` fail it;
a program that cannot serve ``--model dmp`` fails in set-up."""

import pytest
import torch

from perfbench import control, harness
from perfbench.tests import small

torch.set_num_threads(1)
CELL = "dmp_enron.serve_b128"
DRIVER = harness.load_module("drivers", harness.load_workload(CELL)["driver"])


def _reading(kind, fault=None):
    wl, cfg = small.cell(CELL)
    return control.reading(CELL, small.SEED, 0.3, kind=kind, fault=fault, device="cpu",
                           workload=wl, config=cfg)


def test_sound_run_passes_and_the_bfloat16_control_fails():
    sound, control_ = _reading("sound"), _reading("control")
    assert sound["correct"] and sound["attempted"] >= 1
    limit = harness.load_workload(CELL)["check"]["dmp_summary_gap"]
    assert sound["values"]["dmp_summary_gap"] < limit < control_["values"]["dmp_summary_gap"]


@pytest.mark.parametrize("fault", DRIVER.FAULTS)
def test_each_fault_fails_the_check(fault):
    assert not _reading("fault", fault)["correct"]


def test_a_program_without_dmp_serving_fails_in_setup(monkeypatch):
    """As the program did before it served DMP: ``build_model_and_adj`` takes
    only trainable models, so set-up raises at once."""
    from gn_ode_sir_tpu_torch.cli import worker

    monkeypatch.setattr(worker, "build_model_and_adj",
                        lambda args, g, **kw: (worker.build_model(args, g.n_nodes), None))
    wl, cfg = small.cell(CELL)
    with pytest.raises(ValueError, match="trainable"):
        DRIVER.setup(cfg, wl["traffic"], small.SEED, "cpu")
