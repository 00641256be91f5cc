"""Host ms per request from the scenarios' upload to the end of the forward:
the summed durations of the program's ``serve.upload`` and ``serve.forward``
spans (scenarios to the device; prediction and summary reduction) in the
profiled stretch over its requests. Not an enqueue time alone: it holds the
host's wait for the card wherever the forward blocks on the stream, as
``GNODE.predict``'s copy of its label-time index from pageable memory does
after the field is enqueued. None where the program has no such span."""

from perfbench import spans


def read(run):
    return spans.per_unit_ms(run, ["serve.upload", "serve.forward"], "requests")
