"""GN-ODE: continuous-time Graph-Network ODE for SIR dynamics
(port of ``gn_ode_sir_tpu.models.gnode``).

- C7, batched-trials single graph: ``activation='sigmoid'``, ``method='euler'``.
- C6, legacy dense single trial: ``activation='relu'``,
  ``deriv_layernorm=True``, ``encode_r=False``, ``method='rk4'``.

``method`` is a fixed-grid solver ('euler', 'midpoint', 'rk4', 'dopri5') or
'dopri5_adaptive' (budgeted adaptive dopri5 with dense output,
``solver_budget`` attempts); ``adjoint`` is 'direct', 'checkpoint' or
'backsolve' (fixed-grid methods only).

Forward math:
  encode:  E_c = relu(W_enc c0 + b_enc),  c in {S, I, R}
  dy/dt:   Z_c = act(W_f E_c + b_f)
           AI  = A @ Z_I
           dS  = -beta * AI .* Z_S
           dI  = -dS - gamma * Z_I
           dR  = gamma * Z_I
  decode:  p_c = W_d2 relu(W_d1 y_c + b_d1) + b_d2
           (S, I, R) = softmax over the three channels
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from gn_ode_sir_tpu_torch.models.common import layer_norm, linear, linear_init
from gn_ode_sir_tpu_torch.odeint import integer_time_indices, odeint_grid, solvers
from gn_ode_sir_tpu_torch.odeint.dopri import odeint_grid_adaptive
from gn_ode_sir_tpu_torch.ops.gnode_step import gnode_step, sir_derivative


def _map_params(fn, params: dict) -> dict:
    return {k: _map_params(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


def _sigmoid(z: torch.Tensor) -> torch.Tensor:
    """In bf16, 1 / (1 + exp(-z)) rounded after each op, as XLA expands the
    reference's logistic; ``torch.sigmoid`` rounds once and drifts from it by
    ~1e-2 over 39 euler steps. f32 takes the one fused kernel."""
    if z.dtype == torch.bfloat16:
        return torch.reciprocal(1 + torch.exp(-z))
    return torch.sigmoid(z)


def gnode_ode_func(t, y, args, *, activation: str, deriv_layernorm: bool):
    """The GN-ODE vector field. y = (S, I, R) embeddings, each [B, n, h].

    Dtype-polymorphic: with a bf16 state every op stays bf16 and A·Z_I (an
    f32 result from every adjacency backend) is cast back to the state
    dtype. The recovered channel's Z_R never enters the derivative, so only
    Z_S and Z_I are computed."""
    params, beta, gamma, adj = args
    dt = y[0].dtype
    z = linear(params["func"], torch.stack(y[:2]))  # [2, B, n, h]
    z = _sigmoid(z) if activation == "sigmoid" else torch.relu(z)
    zs, zi = z[0], z[1]
    ds, di, dr = sir_derivative(adj.matvec(zi).to(dt), zs, zi, beta, gamma)
    if deriv_layernorm:  # legacy dense variant
        ln = lambda u: layer_norm(params["ln_scale"], params["ln_bias"], u)
        ds, di, dr = ln(ds), ln(di), ln(dr)
    return (ds, di, dr)


def _decode(params: dict, traj) -> torch.Tensor:
    """(S, I, R) trajectory tuple of [T, B, n, h] -> probabilities [T, B, n, 3]."""
    return _decode_stacked(params, torch.stack(traj, dim=-2).float())


def _decode_stacked(params: dict, y: torch.Tensor) -> torch.Tensor:
    """States [T, B, n, 3, h] (the channels stacked) -> probabilities [T, B, n, 3]."""
    u = torch.relu(linear(params["dec1"], y))
    v = linear(params["dec2"], u)[..., 0]  # [T, B, n, 3]
    return torch.softmax(v, dim=-1)


@dataclasses.dataclass(frozen=True)
class GNODE:
    """Config + init/apply for the GN-ODE model family."""

    hidden: int = 64
    max_time: int = 20
    delta_t: float = 0.5
    method: str = "euler"
    adjoint: str = "checkpoint"
    activation: str = "sigmoid"
    deriv_layernorm: bool = False
    encode_r: bool = True
    compute_dtype: str = "f32"  # 'bf16': ODE state + field matmuls in bfloat16
    solver_budget: int = 0  # dopri5_adaptive's global attempt budget
    # (0: the solver's default of 2 * (T_grid - 1) attempts)

    @property
    def ts(self) -> np.ndarray:
        return np.arange(0.0, self.max_time, self.delta_t, dtype=np.float32)

    def init(self, generator: torch.Generator, *, device) -> dict:
        lin = lambda i, o: linear_init(generator, i, o, device=device)
        params = {
            "enc": lin(1, self.hidden),
            "func": lin(self.hidden, self.hidden),
            "dec1": lin(self.hidden, 4),
            "dec2": lin(4, 1),
        }
        if self.deriv_layernorm:
            params["ln_scale"] = torch.ones(self.hidden, device=device)
            params["ln_bias"] = torch.zeros(self.hidden, device=device)
        return params

    def _trajectory(self, params, adj, s0, i0, r0, beta, gamma):
        enc = lambda c: torch.relu(linear(params["enc"], c[..., None]))
        s = enc(s0)
        i = enc(i0)
        r = enc(r0) if self.encode_r else torch.zeros_like(s)
        fparams = params
        if self.compute_dtype == "bf16":
            cast = lambda x: x.to(torch.bfloat16)
            s, i, r = cast(s), cast(i), cast(r)
            fparams = _map_params(cast, params)
        func = partial(gnode_ode_func, activation=self.activation,
                       deriv_layernorm=self.deriv_layernorm)
        args = (fparams, beta, gamma, adj)
        if self.method == "dopri5_adaptive":
            return odeint_grid_adaptive(func, (s, i, r), self.ts, args,
                                        total_steps=self.solver_budget or None)
        # backsolve differentiates the field params and the rates, not the
        # adjacency
        return odeint_grid(func, (s, i, r), self.ts, args, method=self.method,
                           adjoint=self.adjoint, diff_mask=(True, True, True, False))

    def apply(self, params, adj, s0, i0, r0, beta, gamma, *, rng=None, train=False):
        """Full-grid forward.

        Args:
          adj: an adjacency with ``matvec`` (DenseAdj, CooAdj, Spmm2Adj).
          s0, i0, r0: [B, n] initial per-node state indicators (tensors).
          beta, gamma: [B] per-trial SIR rates.
          rng, train: accepted for a uniform model interface (GNODE is
            deterministic).
        Returns probabilities [T_grid, B, n, 3] (softmax over SIR).
        """
        del rng, train
        return _decode(params, self._trajectory(params, adj, s0, i0, r0, beta, gamma))

    def _fused_forward(self, params, tensors) -> bool:
        """Whether :meth:`predict` takes :meth:`_label_states`: no gradient is
        recorded, the method is the solver table's own euler step (the step
        the fused forward computes; an entry replaced at run time takes the
        old path), in float32 with a sigmoid or relu field and no layer norm,
        and the inputs are float32 tensors outside any ``torch.func``
        transform (the ensemble's ``vmap``).

        The benchmark's serving fault ``state_unchanged`` replaces the table's
        euler entry, so under it serving runs the old path, not K3. The
        table check is a stopgap: it goes, for ``method == "euler"``, once
        that fault is planted on :func:`gnode_step` (PERF.md, Open
        questions)."""
        leaves = (params["enc"]["w"], params["func"]["w"], *tensors)
        return (not torch.is_grad_enabled()
                and solvers.METHODS.get(self.method) is solvers._euler
                and self.compute_dtype == "f32" and not self.deriv_layernorm
                and self.activation in ("sigmoid", "relu")
                and not torch._C._are_functorch_transforms_active()
                and all(t.dtype == torch.float32 for t in leaves))

    def _label_states(self, params, adj, s0, i0, r0, beta, gamma) -> torch.Tensor:
        """The euler forward without autograd, for :meth:`predict`: the states
        at the label times, [max_time, B, n, 3, h], the decoder's input.

        The same ops in the same order as :meth:`_trajectory` and
        :func:`_decode`'s stack, so the same bits, but in place: the encoder
        writes the working state [3, B, n, h], whose S and I rows are the
        matrix that the field's linear reads; the linear, its bias and the
        activation write one [2, B, n, h] buffer; K3 (:func:`gnode_step`)
        updates the state and, at a label time, writes it into the decoder's
        input. Nothing is stacked or gathered after the loop."""
        b, n = s0.shape
        h = params["func"]["w"].shape[0]
        f32 = {"dtype": torch.float32, "device": s0.device}
        y = torch.empty((3, b, n, h), **f32)
        z = torch.empty((2, b, n, h), **f32)
        grid_index = integer_time_indices(self.max_time, self.delta_t).tolist()
        states = torch.empty((len(grid_index), b, n, 3, h), **f32)
        slots = {}  # grid index -> the label times it gives
        for k, j in enumerate(grid_index):
            slots.setdefault(j, []).append(k)
        enc = params["enc"]
        for c, x0 in enumerate((s0, i0, r0)):
            if c == 2 and not self.encode_r:
                y[2].zero_()
            else:
                torch.mm(x0.reshape(-1, 1), enc["w"], out=y[c].view(-1, h))
                y[c].add_(enc["b"]).relu_()
        for k in slots.get(0, ()):
            states[k].copy_(y.permute(1, 2, 0, 3))
        w, bias = params["func"]["w"], params["func"]["b"]
        activate = torch.sigmoid_ if self.activation == "sigmoid" else torch.relu_
        beta, gamma = (x.to(torch.float32).contiguous() for x in (beta, gamma))
        ts = self.ts
        dt = ts[1] - ts[0]
        for j in range(1, len(ts)):
            torch.mm(y[:2].view(-1, h), w, out=z.view(-1, h))
            activate(z.add_(bias))
            first, *more = slots.get(j, (None,))
            gnode_step(adj.matvec(z[1]), z[0], z[1], y, beta, gamma, dt,
                       out=None if first is None else states[first])
            for k in more:
                states[k].copy_(states[first])
        return states

    def predict(self, params, adj, s0, i0, r0, beta, gamma, *, rng=None, train=False):
        """Probabilities at integer label times: [max_time, B, n, 3].

        The decode is pointwise in time, so it runs on the resampled states
        only — the same numbers as resampling :meth:`apply`'s output. Without
        autograd, the euler forward runs in place (:meth:`_label_states`);
        everything else takes :meth:`_trajectory`."""
        del rng, train
        if self._fused_forward(params, (s0, i0, r0)):
            return _decode_stacked(
                params, self._label_states(params, adj, s0, i0, r0, beta, gamma))
        traj = self._trajectory(params, adj, s0, i0, r0, beta, gamma)
        idx = torch.as_tensor(integer_time_indices(self.max_time, self.delta_t),
                              dtype=torch.long, device=traj[0].device)
        return _decode(params, tuple(c[idx] for c in traj))


def device_activation_budget(device=None, default: int = 2_000_000_000) -> int:
    """Activation-memory budget for the direct solver: 1/8 of the card's
    memory from ``torch.cuda.mem_get_info``; ``default`` (2 GB) on the CPU."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(total) // 8
    return default


def solver_policy(n_nodes: int, hidden: int, batch_size: int, max_time: int,
                  delta_t: float, adjoint: str = "auto", unroll: int = 0,
                  budget_bytes: int | None = None, device=None):
    """Resolve (adjoint, solver_unroll): 'auto' picks direct while the
    T*3*B*n*h*4-byte trajectory fits ``budget_bytes`` (default: from
    ``device``), else the checkpointed solver."""
    n_steps = int(round(max_time / delta_t))
    if budget_bytes is None:
        budget_bytes = device_activation_budget(device)
    if adjoint == "auto":
        est = n_steps * 3 * batch_size * n_nodes * hidden * 4
        adjoint = "direct" if est < budget_bytes else "checkpoint"
    if unroll <= 0:
        unroll = (n_steps - 1) if adjoint == "direct" else 1
    return adjoint, max(1, unroll)


def legacy_dense_gnode(hidden: int = 32, max_time: int = 20, delta_t: float = 0.5) -> GNODE:
    """The C6 single-trial dense variant."""
    return GNODE(
        hidden=hidden,
        max_time=max_time,
        delta_t=delta_t,
        method="rk4",
        activation="relu",
        deriv_layernorm=True,
        encode_r=False,
    )
