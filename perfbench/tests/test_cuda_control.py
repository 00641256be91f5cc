"""On the card, at a small size: the control of every cell (the program
with TF32 on for the GN-ODE cells, the reference with bfloat16 thresholds
for the label cell) comes out not correct, and a sound run correct.

    python -m pytest perfbench/tests/test_cuda_control.py -m cuda -q
"""

import pytest
import torch

from perfbench import control, harness
from perfbench.tests import small

CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_incorrect_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the card's kernels exist only there")
    # hubs of some hundreds of edges: on the CPU tests' 60 nodes the serving
    # control read under its limit on the card
    wl, cfg = small.cell(cell, nodes=3000, directed_edges=40_000)
    for kind, correct in (("sound", True), ("control", False)):
        row = control.reading(cell, small.SEED, 0.5, kind=kind, workload=wl, config=cfg)
        assert row["correct"] is correct, row
