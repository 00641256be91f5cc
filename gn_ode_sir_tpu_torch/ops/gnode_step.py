"""K3: the euler SIR update of the GN-ODE's no-grad forward, as a CUDA kernel.

One field evaluation's update, from ``ai = A @ zi`` (K1) and the field's
activations ``zs``, ``zi`` [B, n, h] and per-scenario rates [B]:

    ds = -beta * ai * zs,  di = -ds - gamma * zi,  dr = gamma * zi
    (s, i, r) += dt * (ds, di, dr)      in place in the state [3, B, n, h]
    out[b, node, c, :] = new state c    at a label time only

``out`` is one time slice [B, n, 3, h] of the decoder's input, the layout
that stacking the three channels on the second-to-last axis gives.

It replaces no TPU kernel: the JAX package leaves these ops to XLA, which
fuses them on the TPU, and in eager PyTorch they are a dozen elementwise
kernels a field evaluation. The kernel, ``gn_ode_sir_tpu_torch/csrc/
gnode_step.cu``, reads its six inputs once and writes the state once (36
bytes an element, 48 at a label time), which bounds it on an H100: 0.19 ms
at [8, 33,696, 64] at 3.35 TB/s.

Beside it, its plain PyTorch version: :func:`sir_derivative`, the field's
own ops (``models/gnode.py::gnode_ode_func`` calls it), and the solver's
``_axpy``, in :func:`gnode_step_plain`. Every product and sum of the kernel
rounds as these ops round, so the two give the same bits. :func:`gnode_step`
takes the plain version only for CPU tensors; a CUDA tensor launches the
kernel or raises. ``gnode_step.launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from gn_ode_sir_tpu_torch.odeint.solvers import _axpy
from gn_ode_sir_tpu_torch.ops import _kernels


def sir_derivative(ai, zs, zi, beta, gamma):
    """(dS, dI, dR) of the GN-ODE field from A·Z_I, Z_S, Z_I [B, n, h] and the
    rates [B], in the dtype of ``zs``."""
    dt = zs.dtype
    b = beta.to(dt)[:, None, None]
    g = gamma.to(dt)[:, None, None]
    ds = -b * ai * zs
    di = -ds - g * zi
    dr = g * zi
    return ds, di, dr


def gnode_step_plain(ai, zs, zi, state, beta, gamma, dt: float, out=None) -> None:
    """The plain PyTorch version of K3: :func:`sir_derivative` and one euler
    step of ``_axpy``, written into ``state`` (and ``out``)."""
    new = _axpy(tuple(state), sir_derivative(ai, zs, zi, beta, gamma), dt)
    for c, y in enumerate(new):
        state[c].copy_(y)
    if out is not None:
        out.copy_(state.permute(1, 2, 0, 3))


def _check(ai, zs, zi, state, beta, gamma, out) -> None:
    if zs.dim() != 3:
        raise ValueError(f"zs must be [B, n, h], got {tuple(zs.shape)}")
    b, n, h = zs.shape
    want = {"ai": (ai, (b, n, h)), "zi": (zi, (b, n, h)), "state": (state, (3, b, n, h)),
            "beta": (beta, (b,)), "gamma": (gamma, (b,))}
    if out is not None:
        want["out"] = (out, (b, n, 3, h))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")


def _launch(ai, zs, zi, state, beta, gamma, dt, out) -> None:
    tensors = (ai, zs, zi, state, beta, gamma) + (() if out is None else (out,))
    _kernels.check("gnode_step", zs.device, [((torch.float32,), tensors)], tensors)
    b, n, h = zs.shape
    if not zs.numel():
        return
    _kernels.launch("gnode_step", zs.device, ai.data_ptr(), zs.data_ptr(), zi.data_ptr(),
                    state[0].data_ptr(), state[1].data_ptr(), state[2].data_ptr(),
                    beta.data_ptr(), gamma.data_ptr(), float(np.float32(dt)),
                    None if out is None else out.data_ptr(), b, n * h, h)
    gnode_step.launches += 1


def gnode_step(ai, zs, zi, state, beta, gamma, dt: float, out=None) -> None:
    """K3: one euler step of the GN-ODE's SIR update, in place in ``state``
    [3, B, n, h] (S, I, R), from ``ai``, ``zs``, ``zi`` [B, n, h] and the
    rates ``beta``, ``gamma`` [B]; ``dt`` is rounded to float32 as the solver
    rounds it. ``out`` [B, n, 3, h], where given, receives the new state.

    A CUDA tensor launches the kernel (float32, contiguous, or it raises); a
    CPU tensor takes :func:`gnode_step_plain`."""
    _check(ai, zs, zi, state, beta, gamma, out)
    if _kernels.on_cuda("gnode_step", zs.device):
        return _launch(ai, zs, zi, state, beta, gamma, dt, out)
    return gnode_step_plain(ai, zs, zi, state, beta, gamma, dt, out)


gnode_step.launches = 0  # kernel launches since the last reset (CPU calls do not count)
