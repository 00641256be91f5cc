"""Host ms per optimiser step in the program's optimiser phase
(``optimizer.step()``): the summed durations of the program's
``train.optimizer`` spans in the profiled stretch over its steps. None where
the program has no such span."""

from perfbench import spans


def read(run):
    return spans.per_unit_ms(run, ["train.optimizer"], "steps")
