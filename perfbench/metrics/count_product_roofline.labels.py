"""The label path's count product (``torch._int_mm``) in the traced stretch:
its least time (``counts/labels.py``) over the union of its kernel spans, %."""

from perfbench import readers


def read(run):
    return readers.count_product_roofline(run)
