"""Host ms per optimiser step in the program's forward phase (gathers,
adjacency, prediction, loss): the summed durations of the program's
``train.forward`` spans in the profiled stretch over its steps. None where
the program has no such span."""

from perfbench import spans


def read(run):
    return spans.per_unit_ms(run, ["train.forward"], "steps")
