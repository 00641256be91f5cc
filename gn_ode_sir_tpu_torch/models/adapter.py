"""Adapter giving the time-unrolled GNN baselines the shared SIR-trial
interface used by the training engine (port of
``gn_ode_sir_tpu.models.adapter``).

The GCN/GIN feed per-node features [S0, I0, R0, beta, gamma] and predict
t = 1..window-1; the GN-ODE engine speaks (s0, i0, r0, beta, gamma) ->
[T, B, n, 3]. This adapter bridges the two so one fit loop serves every
trainable model family. The t=0 slice is filled with the exact initial
condition (it is excluded from the loss, which starts at t >= 1).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TimeUnrolledSIR:
    """Wraps a GCN/GIN into the (s0, i0, r0, beta, gamma) trial interface.

    ``with_rates=False`` gives the 3-feature variant ([S0, I0, R0] only).
    """

    gnn: object  # GCN or GIN dataclass
    with_rates: bool = True

    @property
    def max_time(self) -> int:
        return self.gnn.window

    def init(self, generator: torch.Generator, *, device) -> dict:
        return self.gnn.init(generator, device=device)

    def predict(self, params, adj, s0, i0, r0, beta, gamma, *, rng=None, train=False):
        B, n = s0.shape
        feats = [s0[..., None], i0[..., None], r0[..., None]]
        if self.with_rates:
            feats += [
                beta[:, None, None].expand(B, n, 1),
                gamma[:, None, None].expand(B, n, 1),
            ]
        x = torch.cat(feats, dim=-1)
        out = self.gnn.apply(params, adj, x, rng=rng, train=train)  # [T-1, B, n, 3]
        t0 = torch.stack([s0, i0, r0], dim=-1)[None]  # exact initial condition
        return torch.cat([t0, out], dim=0)  # [T, B, n, 3]
