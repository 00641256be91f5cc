"""Device idle ms per label call while the host prepares a trial chunk,
unpacks its sums or turns the call's sums into probabilities: the measure of
the union of the program's ``labels.prepare``, ``labels.unpack`` and
``labels.probs`` spans in the profiled stretch less the part of it the union
of the device's operation spans covers, over the stretch's calls. None where
the program has no such span."""

from perfbench import spans


def read(run):
    return spans.idle_within_ms(run, ["labels.prepare", "labels.unpack", "labels.probs"],
                                "calls")
