"""gn_ode_sir_tpu_torch — the PyTorch/CUDA port of ``gn_ode_sir_tpu``.

The JAX package stays the reference; this package re-implements, in PyTorch
for an NVIDIA H100 and module for module, its serving path and its
single-graph pipeline from Monte-Carlo labels through training to the CSV:

- ``graphs``  — :class:`Graph` (sorted COO edge list) and its loaders.
- ``ops``     — dense/COO SpMM, and the hand-written CUDA SpMM kernel
                (``csrc/spmm2.cu``, forward and gradient) that replaces the
                chunked Pallas kernel
                ``gn_ode_sir_tpu/ops/pallas_spmm2.py::_kernel``.
- ``sim``     — the vectorized Monte-Carlo SIR simulator, whose step is the
                CUDA kernel ``csrc/sir_step.cu`` in place of
                ``gn_ode_sir_tpu/sim/pallas_step.py::_step_kernel``.
- ``odeint``  — fixed-grid euler/midpoint/rk4/dopri5 as a Python loop.
- ``models``  — the GN-ODE model family (C7 and the legacy C6 variant).
- ``train``   — loss, trial datasets, ``fit``, the params checkpoint and
                the JAX <-> port params converter.
- ``utils``   — experiment config, label cache, CSV results sink.
- ``cli``     — the experiment worker (``cli.worker``) and the serving entry
                point ``cli.infer``.

Importing the package imports nothing heavy: each subpackage is imported by
name. The package never imports ``jax`` or ``gn_ode_sir_tpu``.
"""

__version__ = "0.1.0"
