"""Time-grid resampling: solver grid -> integer label times
(port of ``gn_ode_sir_tpu.odeint.resample``). Label time t reads solver grid
index ``int(t / deltaT)``."""

from __future__ import annotations

import numpy as np
import torch


def integer_time_indices(max_time: int, delta_t: float) -> np.ndarray:
    """Solver-grid indices of the integer times 0..max_time-1."""
    return np.array([int(i / delta_t) for i in range(max_time)], dtype=np.int32)


def resample_integer_times(traj: torch.Tensor, max_time: int, delta_t: float):
    """Gather trajectory values (leading time axis) at integer times."""
    idx = torch.as_tensor(integer_time_indices(max_time, delta_t),
                          dtype=torch.long, device=traj.device)
    return traj[idx]


def resample_expected_counts(traj: torch.Tensor, max_time: int, delta_t: float):
    """Expected COUNT trajectory at integer times: the sum over the node axis
    (axis 1) of :func:`resample_integer_times` (the reference resamplers'
    ``count=True`` mode, aggregate infected-count curves)."""
    return resample_integer_times(traj, max_time, delta_t).sum(dim=1)
