"""Simulations completed over the whole window, per second (host clock;
the call under way when the window closes finishes and counts)."""


def read(run):
    w = run.window
    return w["sims"] / w["seconds"] if w.get("calls") else None
