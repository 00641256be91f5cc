"""K1 and K1-bwd (``csrc/spmm2.cu``) in the traced training stretch: the sum
of each apply's least time (``counts/spmm.py``) over the union of K1's
kernel spans, %."""

from perfbench import readers


def read(run):
    return readers.train_k1(run)
