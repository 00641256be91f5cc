"""Drivers, one file each, found by the name a workload file gives:
``setup``, ``window``, ``traced``, ``check``, ``shapes`` and ``attempted``."""
