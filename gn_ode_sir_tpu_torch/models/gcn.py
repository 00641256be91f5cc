"""Time-unrolled GCN baseline (port of ``gn_ode_sir_tpu.models.gcn``).

``window`` stacked GCN convolutions where layer L's output is the prediction
for label time t = L+1; per-time decode fc1 -> relu -> fc2 -> softmax over
(S, I, R). The convolution is the normalized SpMM
(``ops.gcn_norm_edges``: D^-1/2 (A+I) D^-1/2) on the shared adjacency
backends; trial batching is a leading batch axis.

The forward uses only layers 0..window-2 (window-1 outputs, compared against
labels at t >= 1): ``apply`` returns [window-1, B, n, 3].
"""

from __future__ import annotations

import dataclasses

import torch

from gn_ode_sir_tpu_torch.models.common import dropout as _dropout
from gn_ode_sir_tpu_torch.models.common import linear, linear_init


@dataclasses.dataclass(frozen=True)
class GCN:
    input_dim: int = 5
    hidden_dim: int = 8
    penultimate_dim: int = 4
    n_targets: int = 3
    dropout: float = 0.1
    window: int = 20  # == maxTime

    def init(self, generator: torch.Generator, *, device) -> dict:
        lin = lambda i, o: linear_init(generator, i, o, device=device)
        convs = [lin(self.input_dim, self.hidden_dim)]
        for _ in range(1, self.window):
            convs.append(lin(self.hidden_dim, self.hidden_dim))
        return {
            "convs": convs,
            "fc1": lin(self.hidden_dim, self.penultimate_dim),
            "fc2": lin(self.penultimate_dim, self.n_targets),
        }

    def apply(self, params, adj, x, *, rng=None, train: bool = False):
        """x: [B, n, input_dim]; adj: normalized adjacency; ``rng``: a
        ``torch.Generator`` for the dropout masks (none: no dropout).

        Returns [window-1, B, n, 3] softmax probabilities for t = 1..window-1.
        """
        outs = []
        h = x
        for layer in range(self.window - 1):
            p = params["convs"][layer]
            # GCNConv order: aggregate(X W) then add bias (PyG semantics).
            h = adj.matvec(h @ p["w"]) + p["b"]
            h = torch.relu(h)
            h = _dropout(rng, h, self.dropout, train)
            outs.append(h)
        y = torch.stack(outs)  # [window-1, B, n, hidden]
        y = torch.relu(linear(params["fc1"], y))
        y = _dropout(rng, y, self.dropout, train)
        y = linear(params["fc2"], y)
        return torch.softmax(y, dim=-1)
