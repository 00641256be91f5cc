"""Time-unrolled GIN baseline (port of ``gn_ode_sir_tpu.models.gin``).

``window`` stacked GIN convolutions, layer L -> prediction for time t = L+1.
Each conv is ``MLP((1+eps) x + sum_{j in N(i)} x_j)`` with eps = 0 and
MLP = Linear-ReLU-BatchNorm-Linear-ReLU-BatchNorm. Aggregation is the raw
(unnormalized) sum SpMM.

BatchNorm always normalizes with the statistics of the current node batch
(no running averages), which keeps the model a pure function.
"""

from __future__ import annotations

import dataclasses

import torch

from gn_ode_sir_tpu_torch.models.common import dropout as _dropout
from gn_ode_sir_tpu_torch.models.common import linear, linear_init


def _batch_norm(p, x, eps: float = 1e-5):
    # Normalize over all axes except features (node-batch statistics).
    axes = tuple(range(x.dim() - 1))
    mu = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _mlp_init(generator, d_in, d_hidden, device):
    norm = lambda: {"scale": torch.ones((d_hidden,), device=device),
                    "bias": torch.zeros((d_hidden,), device=device)}
    return {
        "lin1": linear_init(generator, d_in, d_hidden, device=device),
        "bn1": norm(),
        "lin2": linear_init(generator, d_hidden, d_hidden, device=device),
        "bn2": norm(),
    }


def _mlp(p, x):
    x = _batch_norm(p["bn1"], torch.relu(linear(p["lin1"], x)))
    x = _batch_norm(p["bn2"], torch.relu(linear(p["lin2"], x)))
    return x


@dataclasses.dataclass(frozen=True)
class GIN:
    input_dim: int = 5
    hidden_dim: int = 8
    penultimate_dim: int = 4
    n_targets: int = 3
    dropout: float = 0.1
    window: int = 20
    eps: float = 0.0

    def init(self, generator: torch.Generator, *, device) -> dict:
        convs = [_mlp_init(generator, self.input_dim, self.hidden_dim, device)]
        for _ in range(1, self.window):
            convs.append(_mlp_init(generator, self.hidden_dim, self.hidden_dim, device))
        return {
            "convs": convs,
            "fc1": linear_init(generator, self.hidden_dim, self.penultimate_dim, device=device),
            "fc2": linear_init(generator, self.penultimate_dim, self.n_targets, device=device),
        }

    def apply(self, params, adj, x, *, rng=None, train: bool = False):
        """x: [B, n, input_dim]; adj: raw-sum adjacency (no norm); ``rng``: a
        ``torch.Generator`` for the dropout masks (none: no dropout).

        Returns [window-1, B, n, 3] softmax probabilities for t = 1..window-1.
        """
        outs = []
        h = x
        for layer in range(self.window - 1):
            agg = (1.0 + self.eps) * h + adj.matvec(h)
            h = torch.relu(_mlp(params["convs"][layer], agg))
            h = _dropout(rng, h, self.dropout, train)
            outs.append(h)
        y = torch.stack(outs)
        y = torch.relu(linear(params["fc1"], y))
        y = _dropout(rng, y, self.dropout, train)
        y = linear(params["fc2"], y)
        return torch.softmax(y, dim=-1)
