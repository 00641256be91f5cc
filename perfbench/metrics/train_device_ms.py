"""Device ms per optimiser step: the union of the device's operation spans
over the profiled stretch (whole epochs in a multi-graph cell), over the
steps in it. Taken from the trace, it does not carry the host's stalls."""


def read(run):
    if run.trace is None or not run.traced.get("steps"):
        return None
    return 1e3 * run.trace.busy_s() / run.traced["steps"]
