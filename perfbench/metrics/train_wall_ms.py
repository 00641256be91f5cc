"""Wall ms of the whole window over the optimiser steps completed in it
(host clock; the call under way when the window closes finishes and counts)."""


def read(run):
    w = run.window
    return 1e3 * w["seconds"] / w["steps"] if w.get("steps") else None
