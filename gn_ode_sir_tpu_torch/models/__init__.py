"""Model family (port of ``gn_ode_sir_tpu.models``): GNODE (continuous-time
graph-network ODE), GCN, GIN, DMP. The trainable families are functional:
``Model.init(generator, device=...) -> params`` and
``Model.apply(params, ...) -> predictions``."""

from gn_ode_sir_tpu_torch.models.adapter import TimeUnrolledSIR
from gn_ode_sir_tpu_torch.models.dmp import DMPSIR, cave_index
from gn_ode_sir_tpu_torch.models.gcn import GCN
from gn_ode_sir_tpu_torch.models.gin import GIN
from gn_ode_sir_tpu_torch.models.gnode import GNODE, gnode_ode_func, legacy_dense_gnode

__all__ = [
    "GNODE",
    "GCN",
    "GIN",
    "DMPSIR",
    "TimeUnrolledSIR",
    "gnode_ode_func",
    "legacy_dense_gnode",
    "cave_index",
]
