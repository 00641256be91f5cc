"""DMP's recursion (``models/dmp.py``) in the traced serving stretch: the
least time of its edge updates (the program's counter
``dmp_recursion.edge_updates`` times ``counts/dmp.py``'s least bytes an
edge update, at HBM's 3.35 TB/s) over the union of the recursion's kernel
spans (``readers_dmp.py``), %. None where the counters and the trace
disagree."""

from perfbench import readers_dmp
from perfbench.readers import share


def read(run):
    r = readers_dmp.recursion(run)
    return None if r is None else share(r["bound_s"], r["busy_s"])
