"""Host ms per optimiser step in the program's backward phase
(``loss.backward()``: the host waits while the autograd engine enqueues the
backward): the summed durations of the program's ``train.backward`` spans in
the profiled stretch over its steps. None where the program has no such
span."""

from perfbench import spans


def read(run):
    return spans.per_unit_ms(run, ["train.backward"], "steps")
