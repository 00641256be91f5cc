"""Scenarios scored over the whole window, per second (host clock)."""


def read(run):
    w = run.window
    return w["scenarios"] / w["seconds"] if w.get("requests") else None
