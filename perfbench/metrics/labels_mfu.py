"""The untraced window's int8 count-product operations (``counts/labels.py``)
over its wall time, as a share (%) of the int8 peak."""

from perfbench import readers
from perfbench.counts.peaks import H100


def read(run):
    w = run.window
    if not w.get("calls"):
        return None
    return readers.share(readers.labels_ops(run, w), w["seconds"] * H100["int8_ops"])
