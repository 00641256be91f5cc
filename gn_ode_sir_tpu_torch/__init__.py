"""gn_ode_sir_tpu_torch — the PyTorch/CUDA port of ``gn_ode_sir_tpu``.

The JAX package stays the reference; this package re-implements its
serving path in PyTorch for an NVIDIA H100, module for module:

- ``graphs``  — :class:`Graph` (sorted COO edge list) and its loaders.
- ``ops``     — dense/COO SpMM, and the hand-written CUDA SpMM kernel
                (``csrc/spmm2.cu``) that replaces the chunked Pallas kernel
                ``gn_ode_sir_tpu/ops/pallas_spmm2.py::_kernel``.
- ``odeint``  — fixed-grid euler/midpoint/rk4/dopri5 as a Python loop.
- ``models``  — the GN-ODE model family (C7 and the legacy C6 variant).
- ``train``   — the params checkpoint and the JAX <-> port params converter.
- ``cli``     — the worker's model construction and the serving entry
                point ``cli.infer``.

Importing the package imports nothing heavy: each subpackage is imported by
name. The package never imports ``jax`` or ``gn_ode_sir_tpu``.
"""

__version__ = "0.1.0"
