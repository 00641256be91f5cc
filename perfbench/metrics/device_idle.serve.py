"""The device's idle share (%) of the traced stretch: 1 - the union of its
operation spans over the stretch's wall time."""

from perfbench import readers


def read(run):
    return readers.device_idle(run)
