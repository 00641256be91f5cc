"""Host ms per request in the program's ``serve.readback`` span, summed over
the profiled stretch and divided by its requests: the wait for what the card
still has to do when the forward's enqueue returns (the serving forwards
block on nothing before it, so this is most of the request's device time),
and the copy of the summaries back. None where the program has no such
span."""

from perfbench import spans


def read(run):
    return spans.per_unit_ms(run, ["serve.readback"], "requests")
