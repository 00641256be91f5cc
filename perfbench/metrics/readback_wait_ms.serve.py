"""Host ms per request in the program's ``serve.readback`` span, summed over
the profiled stretch and divided by its requests: the wait for what the card
still has to do when the forward returns, and the copy of the summaries
back. Where the forward itself blocked on the stream (see
``forward_ms.serve``), only the tail of the request's wait for the card falls
here. None where the program has no such span."""

from perfbench import spans


def read(run):
    return spans.per_unit_ms(run, ["serve.readback"], "requests")
