"""The untraced window's training-step FLOPs (``counts/gnode.py``, op by op,
real nodes and trials) over its wall time, as a share (%) of the f32 peak."""

from perfbench import readers
from perfbench.counts.peaks import H100


def read(run):
    w = run.window
    if not w.get("steps"):
        return None
    return readers.share(readers.train_flops(run, w["units"]), w["seconds"] * H100["f32_flops"])
