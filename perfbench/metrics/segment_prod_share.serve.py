"""The share (%) of DMP's recursion's device time in ``ops/segment.py::
segment_prod``'s scatter-reduce kernels, the node product, in the traced
serving stretch (``readers_dmp.py``). None unless the trace holds as many
of those kernels as the program's counter ``segment_prod.calls`` counted."""

from perfbench import readers_dmp
from perfbench.readers import share


def read(run):
    r = readers_dmp.recursion(run)
    return None if r is None else share(r["segment_prod_s"], r["busy_s"])
