"""Budgeted adaptive Dormand-Prince 5(4) with dense output on a fixed grid
(port of ``gn_ode_sir_tpu.odeint.dopri``).

One global budget of ``total_steps`` embedded 5(4) attempts covers the whole
horizon; an accepted step may stride across several output intervals, and
the grid values come from cubic-Hermite interpolation of the accepted step
that covers each grid time. FSAL (first same as last) reuse gives 6 field
evaluations per attempt, plus one for the first derivative. A step rejected
twice in a row is force-accepted, and grid points past the last accepted
step extrapolate from it: both matter only when the budget is far too
small.

The form is branchless, as the JAX package's: every attempt is computed,
once the controller reaches the end the remaining attempts are masked
no-ops, and acceptance is a ``torch.where`` mask on 0-d device tensors.
The step controller never asks the host for a value, so a solve on a card
queues all its attempts without waiting; the one read back is the [T - 1]
vector of the attempts that cover the grid, after the last attempt.

The solve keeps (y, y_new, f, f_new) of every attempt for the interpolation:
about 4 * total_steps state copies, and the T grid states it returns.
"""

from __future__ import annotations

import numpy as np
import torch

# Dormand-Prince 5(4) tableau
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def _axpy_many(y, ks, coeffs, dt):
    out = []
    for i, leaf in enumerate(y):
        acc = leaf
        for c, k in zip(coeffs, ks):
            if c != 0.0:
                acc = acc + dt * c * k[i]
        out.append(acc)
    return tuple(out)


def _dp_step_fsal(func, t, y, dt, args, f0):
    """One embedded 5(4) attempt reusing ``f0 = f(t, y)``: (y5, y5 - y4,
    f(t + dt, y5)), the last the next attempt's ``f0`` on acceptance."""
    ks = [f0]
    for ci, arow in zip(_C[1:], _A[1:]):
        ks.append(func(t + ci * dt, _axpy_many(y, ks, arow, dt), args))
    y5 = _axpy_many(y, ks, _B5, dt)
    y4 = _axpy_many(y, ks, _B4, dt)
    return y5, tuple(a - b for a, b in zip(y5, y4)), ks[6]


def _error_norm(err, y, y_new, rtol, atol):
    norms = [(e.abs() / (atol + rtol * torch.maximum(a.abs(), b.abs()))).max()
             for e, a, b in zip(err, y, y_new)]
    return torch.stack(norms).max()


def _hermite(theta, dt, y0, y1, f0, f1):
    """Cubic Hermite dense output at fraction ``theta`` (0-d) of an accepted
    step of length ``dt`` (0-d) from state ``y0`` to ``y1``."""
    t2 = theta * theta
    t3 = t2 * theta
    h00, h10 = 2 * t3 - 3 * t2 + 1, t3 - 2 * t2 + theta
    h01, h11 = -2 * t3 + 3 * t2, t3 - t2
    return tuple(h00 * a + (h10 * dt) * fa + h01 * b + (h11 * dt) * fb
                 for a, b, fa, fb in zip(y0, y1, f0, f1))


def odeint_grid_adaptive(func, y0, ts, args=None, *, rtol: float = 1e-5, atol: float = 1e-6,
                         total_steps: int | None = None, max_stride: int = 8):
    """Budgeted adaptive dopri5 with outputs at every grid point ``ts``.

    Returns the dense trajectory, a tuple of [T, ...] tensors whose first
    slice is ``y0``. The solve spends at most ``total_steps`` attempts over
    the whole horizon (default ``2 * (len(ts) - 1)``, at least 3, so that one
    is accepted); ``max_stride`` caps a step at that many grid intervals.
    Differentiable: autograd runs through every attempt."""
    ts_np = np.asarray(ts, np.float32)
    n_t = ts_np.shape[0]
    total_steps = max(int(2 * (n_t - 1) if total_steps is None else total_steps), 3)
    y0 = tuple(y0)
    dev = y0[0].device
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    ts_t = torch.as_tensor(ts_np, device=dev)
    dt0, t_end = ts_np[1] - ts_np[0], ts_np[-1]
    # above the float32 ulp at the horizon: after the last full step t misses
    # t_end by about one ulp, and a smaller threshold would spend the rest of
    # the budget on steps that make no progress
    done_tol = scalar(max(np.float32(4.0) * np.finfo(np.float32).eps * abs(t_end),
                          np.float32(1e-6) * dt0))
    dt0_t, t_end_t = scalar(dt0), scalar(t_end)
    stride = scalar(np.float32(max_stride) * dt0)

    t, y, dt_next = scalar(ts_np[0]), y0, dt0_t
    f = func(t, y, args)
    rejects = torch.zeros((), dtype=torch.int32, device=dev)
    steps = []  # (t, dt, accept, y, y_new, f, f_new) of every attempt
    for _ in range(total_steps):
        remaining = t_end_t - t
        done = remaining <= done_tol
        dt_try = torch.minimum(torch.minimum(dt_next, remaining), stride)
        dt_try = torch.where(done, dt0_t, dt_try)  # finite for the no-op attempt
        y_new, err, f_new = _dp_step_fsal(func, t, y, dt_try, args, f)
        ratio = _error_norm(err, y, y_new, rtol, atol)
        accept = ~done & ((ratio <= 1.0) | (rejects >= 2))
        factor = torch.clamp(0.9 * (ratio + 1e-16) ** (-0.2), 0.2, 5.0)
        dt_next = torch.where(done, dt_next, dt_try * factor)
        rejects = torch.where(accept | done, 0, rejects + 1).to(torch.int32)
        steps.append((t, dt_try, accept, y, y_new, f, f_new))
        t = torch.where(accept, t + dt_try, t)
        y = tuple(torch.where(accept, b, a) for a, b in zip(y, y_new))
        f = tuple(torch.where(accept, b, a) for a, b in zip(f, f_new))

    # each interior grid time is covered by exactly one accepted step
    # (start <= t_q < start + dt); past the last accepted step (a starved
    # budget) the grid extrapolates from that step
    st, sdt, acc = (torch.stack([s[k] for s in steps]) for k in range(3))
    s_idx = torch.arange(total_steps, device=dev)
    t_q = torch.minimum(ts_t[1:], t_end_t - 1e-6)  # the last point inside the last step
    ind = acc[:, None] & (st[:, None] <= t_q[None, :]) & (t_q[None, :] < (st + sdt)[:, None])
    i_cov = (ind * s_idx[:, None]).sum(0)
    last_acc = torch.argmax(s_idx * acc)
    i_j = torch.where(ind.any(0), i_cov, last_acc)
    # clamped so that an extrapolated cubic cannot blow up
    theta = torch.clamp((ts_t[1:] - st[i_j]) / sdt[i_j], 0.0, 2.0)
    picks = i_j.tolist()  # the one read from the device, after the last attempt
    # one grid point at a time: gathering the four states of every point
    # first would hold 4 (T - 1) state copies at once
    dts = sdt[i_j]
    points = [_hermite(theta[q], dts[q], *steps[s][3:7]) for q, s in enumerate(picks)]
    return tuple(torch.stack([y0[c], *(p[c] for p in points)]) for c in range(len(y0)))
