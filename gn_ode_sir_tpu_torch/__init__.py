"""gn_ode_sir_tpu_torch — the PyTorch/CUDA port of ``gn_ode_sir_tpu``.

The JAX package stays the reference; this package re-implements it for an
NVIDIA H100, module for module and with the same public names: serving,
Monte-Carlo labels, single- and multi-graph training, the baselines, the
experiment matrix and the parallel layer.

- ``graphs``   — :class:`Graph` (sorted COO edge list), padded multi-graph
                 batches and the loaders.
- ``ops``      — dense/COO/ELL SpMM, and K1, the hand-written CUDA SpMM
                 (``csrc/spmm2.cu``, forward and gradient) that replaces the
                 chunked Pallas kernel
                 ``gn_ode_sir_tpu/ops/pallas_spmm2.py::_kernel``; K3, the
                 GN-ODE's euler SIR update of the no-grad forward in one
                 CUDA kernel (``csrc/gnode_step.cu``).
- ``sim``      — the vectorized Monte-Carlo SIR simulator, whose step is K2,
                 the CUDA kernel ``csrc/sir_step.cu`` in place of
                 ``gn_ode_sir_tpu/sim/pallas_step.py::_step_kernel``; the
                 Runge-Kutta mean-field baseline.
- ``odeint``   — fixed-grid euler/midpoint/rk4/dopri5, budgeted adaptive
                 dopri5, the direct, checkpoint and backsolve gradients.
- ``models``   — GN-ODE (C7 and the legacy C6), time-unrolled GCN and GIN,
                 DMP.
- ``train``    — loss, trial datasets, ``fit``, multi-graph connectivity,
                 the K-repeat ensemble, the node split, checkpoints and the
                 JAX <-> port params converter.
- ``parallel`` — process groups and device meshes: data-, edge- and
                 member-parallel training, the sharded simulator and sharded
                 serving over ``torch.distributed``.
- ``native``   — the C++ host graph core (built with g++ at first use).
- ``utils``    — experiment config, label cache, CSV sink, timing,
                 profiling and the H100 roofline models.
- ``cli``      — the experiment worker (``cli.worker``), the experiment
                 matrix (``cli.monitorer``) and serving (``cli.infer``).

Importing the package imports nothing heavy: each subpackage is imported by
name. The package never imports ``jax`` or ``gn_ode_sir_tpu``.
"""

__version__ = "0.1.0"
