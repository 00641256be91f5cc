"""Device kernels (copies and fills left out) launched per optimiser step
in the traced stretch."""

from perfbench import profiling


def read(run):
    if run.trace is None or not run.traced.get("steps"):
        return None
    return run.trace.count(profiling.is_kernel) / run.traced["steps"]
