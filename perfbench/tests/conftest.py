"""The harness's tests walk every cell; the DMP serving driver's faults and
control live in ``control_dmp.py``, which lets ``faults.py`` and
``control.py`` reach them here. A stopgap: delete it, and ``register()``,
once ``faults.py`` and ``control.py`` find a driver's own ``FAULTS``,
``plant`` and control; add no other driver through it."""

from perfbench import control_dmp

control_dmp.register()
