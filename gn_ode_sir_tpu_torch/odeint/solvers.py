"""Fixed-step explicit ODE solvers over a uniform time grid
(port of ``gn_ode_sir_tpu.odeint.solvers``).

The ODE function has signature ``func(t, y, args)`` with ``y`` a tuple of
tensors. The JAX ``lax.scan`` becomes a Python loop. Step sizes are computed
in float32 as the JAX side computes them, then rounded to each state
tensor's dtype.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

ADJOINTS = ("direct", "checkpoint", "backsolve")


def _axpy(y, d, h):
    """y + h*d over tuples, preserving each state tensor's dtype (``h`` is
    rounded to that dtype first, so a bf16 state stays bf16)."""
    out = []
    for a, b in zip(y, d):
        ha = torch.tensor(float(h), dtype=a.dtype).item()
        out.append(a + ha * b.to(a.dtype))
    return tuple(out)


def _euler(func, t, y, dt, args):
    return _axpy(y, func(t, y, args), dt)


def _midpoint(func, t, y, dt, args):
    half = dt / np.float32(2)
    k1 = func(t, y, args)
    k2 = func(t + half, _axpy(y, k1, half), args)
    return _axpy(y, k2, dt)


def _rk4(func, t, y, dt, args):
    half = dt / np.float32(2)
    k1 = func(t, y, args)
    k2 = func(t + half, _axpy(y, k1, half), args)
    k3 = func(t + half, _axpy(y, k2, half), args)
    k4 = func(t + dt, _axpy(y, k3, dt), args)
    ksum = tuple(a + 2 * b + 2 * c + d for a, b, c, d in zip(k1, k2, k3, k4))
    return _axpy(y, ksum, dt / np.float32(6))


# Dormand-Prince 5(4) tableau, used here on the fixed grid (5th-order step).
_DOPRI_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
_DOPRI_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
_DOPRI_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)


def _dopri5(func, t, y, dt, args):
    ks = []
    for ci, arow in zip(_DOPRI_C, _DOPRI_A):
        yi = y
        for aij, kj in zip(arow, ks):
            yi = _axpy(yi, kj, dt * np.float32(aij))
        ks.append(func(t + np.float32(ci) * dt, yi, args))
    out = y
    for bi, ki in zip(_DOPRI_B, ks):
        out = _axpy(out, ki, dt * np.float32(bi))
    return out


METHODS = {
    "euler": _euler,
    "midpoint": _midpoint,
    "rk4": _rk4,
    "dopri5": _dopri5,
}


def step_fn(method: str):
    try:
        return METHODS[method]
    except KeyError:
        raise ValueError(f"unknown method {method!r}; choose from {sorted(METHODS)}")


def odeint_grid(func, y0, ts, args=None, *, method: str = "euler",
                adjoint: str = "checkpoint", diff_mask=None):
    """Integrate ``dy/dt = func(t, y, args)`` over the uniform grid ``ts``.

    Args:
      func: ``(t, y, args) -> dy`` with ``y`` a tuple of tensors.
      y0: initial state tuple at ``ts[0]``.
      ts: [T] strictly increasing, uniformly spaced float32 times.
      method: 'euler' | 'midpoint' | 'rk4' | 'dopri5'.
      adjoint: 'checkpoint' (recompute each step in the backward pass, when
        gradients are enabled) | 'direct' (plain autograd) | 'backsolve'
        (the continuous adjoint of :mod:`~gn_ode_sir_tpu_torch.odeint.adjoint`).
      diff_mask: backsolve only: a bool per top-level entry of ``args``,
        which of them to differentiate (default: all).

    Returns the dense trajectory: a tuple of tensors with a new leading time
    axis [T] whose first slice equals ``y0``.
    """
    if adjoint not in ADJOINTS:
        raise ValueError(f"unknown adjoint {adjoint!r}")
    step = step_fn(method)
    if adjoint == "backsolve":
        from gn_ode_sir_tpu_torch.odeint.adjoint import odeint_grid_backsolve

        return odeint_grid_backsolve(func, y0, ts, args, method=method, diff_mask=diff_mask)
    ts = np.asarray(ts, np.float32)
    dt = ts[1] - ts[0]
    y = tuple(y0)
    traj = [y]
    for t in ts[:-1]:
        if adjoint == "checkpoint" and torch.is_grad_enabled():
            y = checkpoint(lambda *yy, t=t: step(func, t, yy, dt, args), *y,
                           use_reentrant=False)
        else:
            y = step(func, t, y, dt, args)
        traj.append(y)
    return tuple(torch.stack(c) for c in zip(*traj))
