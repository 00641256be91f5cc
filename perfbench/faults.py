"""Faults planted in the program, in memory only, to show that the output
check catches them: each is a context manager that breaks the timed path
underneath the harness.

Each driver (``drivers/<name>.py``) declares its own: ``FAULTS``, the faults
it can have; ``applicable(cfg, traffic)``, those a cell of it can show
(where a driver gives none, every fault in ``FAULTS``); ``plant(fault)``,
the context manager. :func:`applicable` and :func:`plant`
load the driver by the name a workload file gives and ask it, so a new
driver brings its faults in its own file. Here are only what several
drivers share: patching a name for the life of a context, an answer read
one time early, TF32 on (the GN-ODE cells' control), and the serving
dispatch's faults, which act above the model.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import harness


def _driver(name: str):
    return harness.load_module("drivers", name)


def applicable(driver: str, cfg: dict, traffic: dict) -> tuple:
    """The faults that a cell of ``driver`` with ``cfg`` and ``traffic`` can
    show: the driver's ``applicable``, or all its ``FAULTS``."""
    module = _driver(driver)
    pick = getattr(module, "applicable", None)
    return tuple(pick(cfg, traffic) if pick else module.FAULTS)


def plant(driver: str, fault: str):
    """The context manager that plants ``fault`` for ``driver``."""
    module = _driver(driver)
    if fault not in module.FAULTS:
        raise ValueError(f"driver {driver!r} has no fault {fault!r}")
    return module.plant(fault)


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _off_by_one(pred: torch.Tensor, axis: int, t: int = 5) -> torch.Tensor:
    if pred.shape[axis] <= t:
        return pred
    out = pred.clone()
    idx = [slice(None)] * pred.dim()
    src = list(idx)
    idx[axis], src[axis] = t, t - 1
    out[tuple(idx)] = pred[tuple(src)]
    return out


@contextlib.contextmanager
def tf32():
    """The program's float32 products in TF32, one precision below the
    configuration's float32 with TF32 off."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def half_dispatch():
    """Serving's ``half_batch``: a dispatch scores the first half of its
    scenarios and repeats them (``cli.infer._dispatch``)."""
    from gn_ode_sir_tpu_torch.cli import infer

    orig = infer._dispatch

    def half(model, params, adj, arrays, reduce_fn=None):
        b = arrays[0].shape[0]
        out = orig(model, params, adj, [a[:max(1, b // 2)] for a in arrays], reduce_fn)
        axis = 0 if reduce_fn is not None else 1  # summaries, or [T, B, n, 3]
        return np.concatenate([out, out], axis=axis).take(range(b), axis=axis)

    return _patched(infer, "_dispatch", half)


def late_summary():
    """Serving's ``answer_altered``: the final recovered fraction read one
    time early (``cli.infer._summary_reduce``)."""
    from gn_ode_sir_tpu_torch.cli import infer

    orig = infer._summary_reduce

    def late(probs, mask=None):
        return orig(torch.cat([probs[:-1], probs[-2:-1]]), mask)

    return _patched(infer, "_summary_reduce", late)


def serving_applicable(names: tuple, traffic: dict) -> tuple:
    """``names`` less ``half_batch`` where a dispatch holds one scenario:
    it has no half to leave out."""
    if min(traffic["scenarios_per_request"], traffic["dispatch_batch"]) < 2:
        return tuple(f for f in names if f != "half_batch")
    return names
