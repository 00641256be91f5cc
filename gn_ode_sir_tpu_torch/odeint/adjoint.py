"""Continuous (backsolve) adjoint for the fixed-grid solvers (port of
``gn_ode_sir_tpu.odeint.adjoint``).

One ``torch.autograd.Function`` over the whole integration. Its forward
keeps no trajectory for the backward pass, only the final state. Its
backward re-integrates the state backwards in time with the same solver
step at -dt, beside the adjoint of the state and of the differentiated
``args`` leaves; each evaluation of the augmented dynamics takes the field's
VJP with ``torch.autograd.grad``. Reconstructing the state by reverse
integration accumulates solver error: the gradient is close to, not equal
to, that of the ``direct`` and ``checkpoint`` adjoints.

Only differentiated ``args`` leaves ride the reverse pass: floating-point
tensors of the subtrees that ``diff_mask`` marks (default: all). Integer
tensors and other objects (an adjacency) are never carried, and an excluded
leaf gets no gradient. GNODE excludes its adjacency: a dense [n, n] matrix
in the reverse carry would cost O(n^2) per step.

On a card each field evaluation of the backward runs K1 once (the reverse
state's derivative, which is also the VJP's forward) and K1-bwd once.
Without gradients (evaluation, serving) the integration runs as the
``direct`` adjoint's, with no Function.
"""

from __future__ import annotations

import numpy as np
import torch

from gn_ode_sir_tpu_torch.odeint.solvers import step_fn

_SLOT = object()  # where a differentiated leaf sits in the skeleton of ``args``


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _split(args, diff_mask):
    """(differentiated leaves, skeleton): the skeleton is ``args`` with
    ``_SLOT`` in place of each differentiated leaf. ``diff_mask``: one bool
    per top-level entry of ``args`` (a tuple), or None for all."""
    diff = []

    def visit(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            diff.append(leaf)
            return _SLOT
        return leaf

    if diff_mask is None:
        skeleton = _tree_map(visit, args)
    else:
        if len(diff_mask) != len(args):
            raise ValueError(f"diff_mask has {len(diff_mask)} entries for {len(args)} args")
        skeleton = tuple(_tree_map(visit, a) if m else a for a, m in zip(args, diff_mask))
    return tuple(diff), skeleton


def _merge(skeleton, diff):
    it = iter(diff)
    return _tree_map(lambda leaf: next(it) if leaf is _SLOT else leaf, skeleton)


def _integrate(func, y0, ts, args, method):
    step = step_fn(method)
    dt = ts[1] - ts[0]
    y = tuple(y0)
    traj = [y]
    for t in ts[:-1]:
        y = step(func, t, y, dt, args)
        traj.append(y)
    return tuple(torch.stack(c) for c in zip(*traj))


class _Backsolve(torch.autograd.Function):
    """inputs: (spec, *y0, *differentiated leaves); outputs: the trajectory."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        func, ts, method, n_y, skeleton = spec
        y0, diff = tensors[:n_y], tensors[n_y:]
        traj = _integrate(func, y0, ts, _merge(skeleton, diff), method)
        ctx.spec = spec
        ctx.y_final = tuple(c[-1].clone() for c in traj)
        ctx.save_for_backward(*diff)
        return traj

    @staticmethod
    def backward(ctx, *g):
        func, ts, method, n_y, skeleton = ctx.spec
        diff = ctx.saved_tensors
        step = step_fn(method)
        y = ctx.y_final
        g = tuple(torch.zeros((len(ts), *c.shape), dtype=c.dtype, device=c.device)
                  if gi is None else gi for gi, c in zip(g, y))

        def aug_dynamics(t, state, _):
            y_, a_ = state[:n_y], state[n_y:2 * n_y]
            with torch.enable_grad():
                yv = tuple(c.detach().requires_grad_(True) for c in y_)
                dv = tuple(leaf.detach().requires_grad_(True) for leaf in diff)
                f = func(t, yv, _merge(skeleton, dv))
                vjp = torch.autograd.grad(f, (*yv, *dv), grad_outputs=a_, allow_unused=True)
            vjp = tuple(torch.zeros_like(x) if v is None else v for v, x in zip(vjp, (*yv, *dv)))
            return (*(c.detach() for c in f), *(-v for v in vjp))

        a = tuple(torch.zeros_like(c) for c in y)
        a_diff = tuple(torch.zeros_like(leaf) for leaf in diff)
        # walk the grid from t_{T-1} down to t_1: absorb the cotangent at t_k,
        # then integrate the augmented system back one interval
        for k in range(len(ts) - 1, 0, -1):
            a = tuple(ai + gi[k] for ai, gi in zip(a, g))
            state = step(aug_dynamics, ts[k], (*y, *a, *a_diff), ts[k - 1] - ts[k], None)
            y, a, a_diff = state[:n_y], state[n_y:2 * n_y], state[2 * n_y:]
        grad_y0 = tuple(ai + gi[0] for ai, gi in zip(a, g))
        return (None, *grad_y0, *a_diff)


def odeint_grid_backsolve(func, y0, ts, args=None, *, method: str = "euler", diff_mask=None):
    """Dense-grid integration whose gradient is the continuous backsolve
    adjoint. ``diff_mask``: optional bool per top-level entry of ``args``
    marking which to differentiate (default: every floating-point tensor).
    Returns the trajectory as :func:`~gn_ode_sir_tpu_torch.odeint.odeint_grid`
    does."""
    ts = np.asarray(ts, np.float32)
    if not torch.is_grad_enabled():
        return _integrate(func, y0, ts, args, method)
    diff, skeleton = _split(args, diff_mask)
    y0 = tuple(y0)
    return _Backsolve.apply((func, ts, method, len(y0), skeleton), *y0, *diff)
