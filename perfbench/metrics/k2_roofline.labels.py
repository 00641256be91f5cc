"""K2 (``csrc/sir_step.cu``) in the traced stretch: its least time
(``counts/labels.py``, bytes) over the union of its kernel spans, %."""

from perfbench import readers


def read(run):
    return readers.k2_roofline(run)
