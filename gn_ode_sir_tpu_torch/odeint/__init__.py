"""ODE solver layer (port of ``gn_ode_sir_tpu.odeint``): fixed-grid
euler/midpoint/rk4/dopri5 with the direct, checkpoint and backsolve
adjoints, budgeted adaptive dopri5, and the integer-time resampling."""

from gn_ode_sir_tpu_torch.odeint.adjoint import odeint_grid_backsolve
from gn_ode_sir_tpu_torch.odeint.dopri import odeint_grid_adaptive

from gn_ode_sir_tpu_torch.odeint.resample import (
    integer_time_indices,
    resample_expected_counts,
    resample_integer_times,
)
from gn_ode_sir_tpu_torch.odeint.solvers import METHODS, odeint_grid, step_fn

__all__ = [
    "METHODS",
    "odeint_grid",
    "odeint_grid_adaptive",
    "odeint_grid_backsolve",
    "step_fn",
    "integer_time_indices",
    "resample_expected_counts",
    "resample_integer_times",
]
