"""Model family (port of ``gn_ode_sir_tpu.models``): the GN-ODE."""

from gn_ode_sir_tpu_torch.models.gnode import GNODE, gnode_ode_func, legacy_dense_gnode

__all__ = ["GNODE", "gnode_ode_func", "legacy_dense_gnode"]
