"""The benchmark of ``gn_ode_sir_tpu_torch``, the PyTorch/CUDA port, on NVIDIA cards.

One command runs one cell once, from the root of a checkout::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root lists the cells, configurations and metrics.
Everything that belongs to one of them sits in a file of its own that the
harness finds by name: ``configs/<config>.json`` (with the plain reference it
names under ``reference/``), ``workloads/<cell>.json`` (configuration, driver,
traffic, the limits of the output check), ``drivers/<driver>.py`` and
``metrics/<metric>.py``. The yardstick (inputs from the seed, operation and
byte counts, peaks, trace reduction, the references and the comparison that
decides ``correct``) lives here and imports nothing of the program beyond its
public entry points; nothing here imports JAX or the JAX package.
"""
