"""Host ms per request from the scenarios' upload to the end of the forward:
the summed durations of the program's ``serve.upload`` and ``serve.forward``
spans (scenarios to the device; prediction and summary reduction) in the
profiled stretch over its requests. The serving forwards (the GN-ODE's fused
no-grad forward, DMP's recursion) copy nothing back to the host, so this is
the upload and the enqueue of the forward's kernels, and any wait for the
card that the enqueue meets (a full launch queue, a blocking copy). None where the
program has no such span."""

from perfbench import spans


def read(run):
    return spans.per_unit_ms(run, ["serve.upload", "serve.forward"], "requests")
