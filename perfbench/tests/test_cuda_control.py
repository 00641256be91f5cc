"""On the card, at a small size: the control of every cell (the program
with TF32 on for the GN-ODE cells, the reference with bfloat16 thresholds
for the label cell, the edge state in bfloat16 for the DMP cell) comes out
not correct, and a sound run correct; under the control and every fault of
the serving cells, the kernels that their windows time (K3; K4 and K5)
launch, and the run comes out not correct.

    python -m pytest perfbench/tests/test_cuda_control.py -m cuda -q
"""

import pytest
import torch

from perfbench import control, faults, harness
from perfbench.tests import small

CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]
# hubs of some hundreds of edges: on the CPU tests' 60 nodes the serving
# control read under its limit on the card
SIZE = {"nodes": 3000, "directed_edges": 40_000}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the card's kernels exist only there")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_incorrect_on_the_card(cell):
    _card()
    wl, cfg = small.cell(cell, **SIZE)
    for kind, correct in (("sound", True), ("control", False)):
        row = control.reading(cell, small.SEED, 0.5, kind=kind, workload=wl, config=cfg)
        assert row["correct"] is correct, row


def _broken(cell: str) -> list:
    wl, cfg = small.cell(cell, **SIZE)
    return [(cell, "control", None)] + [
        (cell, "fault", f) for f in faults.applicable(wl["driver"], cfg, wl["traffic"])]


def _launches_and_fails(cell, kind, fault, counters):
    _card()
    wl, cfg = small.cell(cell, **SIZE)
    before = [c.launches for c in counters]
    row = control.reading(cell, small.SEED, 0.5, kind=kind, fault=fault, workload=wl, config=cfg)
    assert all(c.launches > b for c, b in zip(counters, before)), (before, row)
    assert row["correct"] is False, row


@pytest.mark.cuda
@pytest.mark.parametrize("cell,kind,fault", _broken("dmp_enron.serve_b128"))
def test_k4_and_k5_launch_under_each_dmp_fault(cell, kind, fault):
    from gn_ode_sir_tpu_torch.ops.dmp_step import dmp_marginals, dmp_step

    _launches_and_fails(cell, kind, fault, [dmp_step, dmp_marginals])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,kind,fault", _broken("c7_enron.serve_b8"))
def test_k3_launches_under_each_serving_fault(cell, kind, fault):
    from gn_ode_sir_tpu_torch.ops.gnode_step import gnode_step

    _launches_and_fails(cell, kind, fault, [gnode_step])
