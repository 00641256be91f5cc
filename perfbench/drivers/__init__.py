"""Drivers, one file each, found by the name a workload file gives:
``setup``, ``window``, ``traced``, ``check``, ``shapes`` and ``attempted``
for a run; ``FAULTS``, ``plant`` and ``control_run`` for ``faults.py``
and ``control.py``, and ``applicable`` where a cell of the driver cannot
show every fault in ``FAULTS``; and, where the cell needs more than its
graphs cut for a CPU test, ``cpu_cut`` for ``tests/small.py``."""
