"""K1 (``csrc/spmm2.cu``) in the traced serving stretch: the sum of each
apply's least time (``counts/spmm.py``) over the union of K1's kernel
spans, %."""

from perfbench import readers


def read(run):
    return readers.serve_k1(run)
