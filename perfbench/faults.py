"""Faults planted in the program, in memory only, to show that the output
check catches them: each is a context manager that breaks the timed path
underneath the harness. Which a cell can have follows from its driver.

- ``state_unchanged``: a step that returns its state unchanged (training:
  the optimiser's step; serving: the solver's euler step; labels: K2's
  step).
- ``half_batch``: half of the batch left out and the mean taken over the
  rest (training: the minibatch's loss; serving: a dispatch scores the
  first half of its scenarios and repeats them; labels: half of the
  simulations, the sums doubled).
- ``answer_altered``: an answer altered where it is produced (training and
  labels: the output at one label time is the one before it; serving: the
  final recovered fraction is read one time early).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

BY_DRIVER = {
    "train": ("state_unchanged", "half_batch", "answer_altered"),
    "serve": ("state_unchanged", "half_batch", "answer_altered"),
    "labels": ("state_unchanged", "half_batch", "answer_altered"),
}


def applicable(driver: str, cfg: dict) -> tuple:
    faults = BY_DRIVER[driver]
    if driver == "train" and cfg["training"]["batch_size"] < 2:
        faults = tuple(f for f in faults if f != "half_batch")  # no half of one trial
    return faults


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def _patched_item(table: dict, key, value):
    old = table[key]
    table[key] = value
    try:
        yield
    finally:
        table[key] = old


def _off_by_one(pred: torch.Tensor, axis: int, t: int = 5) -> torch.Tensor:
    if pred.shape[axis] <= t:
        return pred
    out = pred.clone()
    idx = [slice(None)] * pred.dim()
    src = list(idx)
    idx[axis], src[axis] = t, t - 1
    out[tuple(idx)] = pred[tuple(src)]
    return out


def plant(driver: str, fault: str):
    """The context manager that plants ``fault`` for ``driver``."""
    from gn_ode_sir_tpu_torch.cli import infer
    from gn_ode_sir_tpu_torch.models.gnode import GNODE
    from gn_ode_sir_tpu_torch.odeint import solvers
    from gn_ode_sir_tpu_torch.sim import mc_sir
    from gn_ode_sir_tpu_torch.train import loop

    if fault == "state_unchanged":
        if driver == "train":
            return _patched(torch.optim.Adam, "step", lambda self, closure=None: None)
        if driver == "serve":
            return _patched_item(solvers.METHODS, "euler", lambda func, t, y, dt, args: y)
        return _patched(mc_sir, "sir_step", lambda i, r, *a, **k: (i, r))
    if fault == "half_batch":
        if driver == "train":
            orig = loop._batch_loss

            def half(model, params, adj_fn, mask_fn, d, bidx, bw, gi, **kw):
                k = max(1, len(bidx) // 2)
                return orig(model, params, adj_fn, mask_fn, d, bidx[:k], bw[:k], gi[:k], **kw)

            return _patched(loop, "_batch_loss", half)
        if driver == "serve":
            orig = infer._dispatch

            def half(model, params, adj, arrays, reduce_fn=None):
                b = arrays[0].shape[0]
                out = orig(model, params, adj, [a[:max(1, b // 2)] for a in arrays], reduce_fn)
                axis = 0 if reduce_fn is not None else 1  # summaries, or [T, B, n, 3]
                return np.concatenate([out, out], axis=axis).take(range(b), axis=axis)

            return _patched(infer, "_dispatch", half)
        orig = mc_sir._simulate_trials

        def half(a, masks, betas, gammas, seeds, *, sims, max_time, coins):
            return 2 * orig(a, masks, betas, gammas, seeds, sims=max(1, sims // 2),
                            max_time=max_time, coins=coins)

        return _patched(mc_sir, "_simulate_trials", half)
    if fault == "answer_altered":
        if driver == "train":
            orig = GNODE.predict
            return _patched(GNODE, "predict",
                            lambda self, *a, **k: _off_by_one(orig(self, *a, **k), 0))
        if driver == "serve":
            def late(probs, mask=None):
                return orig_reduce(torch.cat([probs[:-1], probs[-2:-1]]), mask)

            orig_reduce = infer._summary_reduce
            return _patched(infer, "_summary_reduce", late)
        orig = mc_sir._to_probs
        return _patched(mc_sir, "_to_probs",
                        lambda sums, sims: tuple(_off_by_one(torch.as_tensor(p), 0).numpy()
                                                 for p in orig(sums, sims)))
    raise ValueError(f"unknown fault {fault!r}")
