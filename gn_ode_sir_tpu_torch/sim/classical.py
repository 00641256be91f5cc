"""Classical mean-field SIR baseline (port of ``gn_ode_sir_tpu.sim.classical``).

The adjacency SIR field dS = -beta (A I) . S, dI = -dS - gamma I,
dR = gamma I, integrated with the port's fixed-grid explicit solvers (rk4 by
default).

Stability: a fixed rk4 at h = 0.5 diverges on a graph with a hub
(beta * max_degree is far beyond rk4's ~2.8 real-axis bound), so the grid is
refined with power-of-two substeps chosen from the diagonal-rate bound (see
:func:`auto_substeps`), and only the coarse-grid states are kept.

All trials of a batch integrate together as a [B, n] state matrix against
the dense {0,1} adjacency: one ``torch.matmul`` per derivative evaluation,
in float32 up to ``_BF16_NODE_THRESHOLD`` nodes; beyond it the adjacency is
held in bf16 (exact for {0,1} entries), the infected state is rounded to
bf16 and the sum is taken in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from gn_ode_sir_tpu_torch.odeint import resample_integer_times
from gn_ode_sir_tpu_torch.odeint.solvers import step_fn

# beyond this node count the dense f32 adjacency exceeds ~6 GB; use bf16
_BF16_NODE_THRESHOLD = 38_000


def sir_field(t, y, args):
    """y = (S, I, R) each [n]; args = (a_dense, beta, gamma)."""
    a, beta, gamma = args
    s, i, r = y
    ai = a @ i
    ds = -beta * ai * s
    di = -ds - gamma * i
    dr = gamma * i
    return (ds, di, dr)


def _neighbour_sum(i: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``I @ A`` in float32 (A symmetric {0,1}). With a bf16 ``a`` the state
    is rounded to bf16, the products are exact and the sum is float32."""
    if a.dtype != torch.bfloat16:
        return i @ a
    if i.device.type == "cuda":
        return torch.mm(i.to(torch.bfloat16), a, out_dtype=torch.float32)
    return i.to(torch.bfloat16).float() @ a.float()


def sir_field_batch(t, y, args):
    """Batched field: y = (S, I, R) each [B, n]; beta/gamma [B, 1]."""
    a, beta, gamma = args
    s, i, r = y
    ai = _neighbour_sum(i, a)
    ds = -beta * ai * s
    dr = gamma * i
    return (ds, -ds - dr, dr)


def _integrate_coarse_batch(y0, a, beta, gamma, *, method, substeps, n_coarse, delta_t):
    """States at the ``n_coarse`` coarse grid points, ``substeps`` internal
    steps per interval: a tuple of [n_coarse, B, n]."""
    step = step_fn(method)
    h = delta_t / substeps
    args = (a, beta, gamma)
    y = y0
    states = [y]
    with torch.no_grad():
        for k in range(n_coarse - 1):
            t0 = np.float32(k) * np.float32(delta_t)
            for j in range(substeps):
                y = step(sir_field_batch, t0 + j * h, y, h, args)
            states.append(y)
    return tuple(torch.stack(c) for c in zip(*states))


def auto_substeps(graph, betas, gamma_max: float, delta_t: float) -> int:
    """Smallest power-of-two refinement keeping every trial's
    ``h * (beta * max_degree + gamma)`` inside rk4's ~2.78 real-axis
    stability extent (with margin: <= 2.5).

    max_degree — not the adjacency's spectral radius — is the binding rate:
    the stiff term is the diagonal per-node decay ``dS_v = -beta (A I)_v
    S_v`` whose coefficient reaches ``beta * deg_v`` when a hub's
    neighbourhood is fully infected."""
    rate = float(np.max(betas)) * float(graph.degrees.max()) + float(gamma_max)
    need = delta_t * rate / 2.5
    return 1 << int(np.ceil(np.log2(need))) if need > 1.0 else 1


def sir_classical_batch(
    graph,
    seed_sets,
    betas,
    gammas,
    *,
    delta_t: float = 0.5,
    max_time: int = 20,
    method: str = "rk4",
    substeps: int | None = None,
    device,
):
    """Mean-field trajectories for B trials at once, integrated on
    ``device``: numpy (I, S, R), each [B, max_time, n]. The dense adjacency
    read is shared by the batch."""
    n = graph.n_nodes
    b = len(seed_sets)
    i0 = np.zeros((b, n), np.float32)
    for k, seeds in enumerate(seed_sets):
        i0[k, np.asarray(seeds)] = 1.0
    betas = np.asarray(betas, np.float32).reshape(b, 1)
    gammas = np.asarray(gammas, np.float32).reshape(b, 1)
    if substeps is None:
        substeps = auto_substeps(graph, betas, float(gammas.max()), delta_t)
    dtype = torch.float32 if n <= _BF16_NODE_THRESHOLD else torch.bfloat16
    a = torch.zeros((n, n), dtype=dtype, device=device)
    a[torch.as_tensor(graph.dst, dtype=torch.long, device=device),
      torch.as_tensor(graph.src, dtype=torch.long, device=device)] = 1
    on = lambda x: torch.as_tensor(x, device=device)
    y0 = (on(1.0 - i0), on(i0), torch.zeros((b, n), device=device))
    traj = _integrate_coarse_batch(
        y0, a, on(betas), on(gammas),
        method=method, substeps=int(substeps),
        n_coarse=int(round(max_time / delta_t)), delta_t=float(delta_t),
    )
    s_s, i_s, r_s = (
        resample_integer_times(x, max_time, delta_t).permute(1, 0, 2).cpu().numpy()
        for x in traj)  # [B, max_time, n]
    return i_s, s_s, r_s


def sir_classical(
    graph,
    seed_nodes,
    beta: float,
    gamma: float,
    *,
    delta_t: float = 0.5,
    max_time: int = 20,
    method: str = "rk4",
    engine: str = "torch",
    substeps: int | None = None,
    device,
):
    """Mean-field S/I/R trajectories at integer times, each [max_time, n].

    Returns (I, S, R) — the reference's return order. ``substeps=None``
    auto-selects the stability refinement (see module docstring).
    ``engine='scipy'`` integrates with scipy's LSODA on the host (float64,
    for exactness comparisons) and does not use ``device``; the default
    integrates on ``device``.
    """
    n = graph.n_nodes

    if engine == "scipy":
        from scipy.integrate import odeint as odeintscp
        from scipy.sparse import coo_matrix

        i0 = np.zeros(n)
        i0[np.asarray(seed_nodes)] = 1.0
        s0 = 1.0 - i0
        r0 = np.zeros(n)
        a_sp = coo_matrix(
            (np.ones(graph.n_edges), (graph.dst, graph.src)), shape=(n, n)
        ).tocsr()

        def field(x, t):
            s, i = x[:n], x[n : 2 * n]
            ai = a_sp @ i
            ds = -beta * ai * s
            di = -ds - gamma * i
            return np.hstack([ds, di, gamma * i])

        ts = np.arange(0, max_time, delta_t)
        sol = odeintscp(field, np.hstack([s0, i0, r0]), ts)
        idx = [int(t / delta_t) for t in range(max_time)]
        return sol[idx, n : 2 * n], sol[idx, :n], sol[idx, 2 * n :]

    i_b, s_b, r_b = sir_classical_batch(
        graph, [seed_nodes], [beta], [gamma],
        delta_t=delta_t, max_time=max_time, method=method, substeps=substeps,
        device=device,
    )
    return i_b[0], s_b[0], r_b[0]
