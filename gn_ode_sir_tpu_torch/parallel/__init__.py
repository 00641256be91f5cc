"""Parallelism layer (port of ``gn_ode_sir_tpu.parallel``): process groups,
device meshes, sharded simulation, data- and edge-parallel training and
sharded serving.

One process per device (``torchrun``-style environment, or
:func:`init_distributed` with explicit arguments), with ``torch.distributed``
collectives over the sub-group of one mesh axis where the JAX package has
``psum`` inside ``shard_map``:

- **data parallelism**: trial batches split over a ``'data'`` axis,
  gradients all-reduced (:func:`make_spmd_train_step`);
- **simulation parallelism**: Monte-Carlo trajectories split over processes,
  K2 on each, indicator sums all-reduced (:func:`simulate_sir_sharded`);
- **edge parallelism**: the dst-sorted edge list cut into blocks, K1 on each
  block's plan, partial node sums all-reduced (:func:`spmm_edge_sharded`,
  :class:`EdgeShardedCooAdj`);
- **member parallelism**: ``train.fit_ensemble(mesh=...)``.
"""

from gn_ode_sir_tpu_torch.parallel.distributed import init_distributed
from gn_ode_sir_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated_sharding
from gn_ode_sir_tpu_torch.parallel.sim import simulate_sir_sharded
from gn_ode_sir_tpu_torch.parallel.spmd import (
    EdgeShardedCooAdj,
    make_spmd_multigraph_train_step_2d,
    make_spmd_predict_fn,
    make_spmd_train_step,
    make_spmd_train_step_2d,
    spmm_edge_sharded,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "data_sharding",
    "replicated_sharding",
    "simulate_sir_sharded",
    "make_spmd_predict_fn",
    "make_spmd_train_step",
    "make_spmd_multigraph_train_step_2d",
    "make_spmd_train_step_2d",
    "EdgeShardedCooAdj",
    "spmm_edge_sharded",
]
