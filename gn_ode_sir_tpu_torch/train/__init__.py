"""Training layer (port of ``gn_ode_sir_tpu.train``): so far only the params
checkpoint that serving reads."""

from gn_ode_sir_tpu_torch.train.checkpoint import (
    params_from_numpy,
    params_to_numpy,
    restore_params,
    save_params,
)

__all__ = ["params_from_numpy", "params_to_numpy", "restore_params", "save_params"]
