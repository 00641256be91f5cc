"""The untraced window's forward FLOPs (``counts/gnode.py``) over its wall
time, as a share (%) of the f32 peak."""

from perfbench import readers
from perfbench.counts.peaks import H100


def read(run):
    w = run.window
    if not w.get("requests"):
        return None
    return readers.share(readers.serve_flops(run, w["requests"]), w["seconds"] * H100["f32_flops"])
