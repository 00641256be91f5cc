"""Legacy transductive protocol: node-index split on a single trial (port of
``gn_ode_sir_tpu.train.node_split``).

The reference's original entry point trains on ONE (seed set, beta, gamma)
trial and splits the graph's NODES 60/20/20, a transductive protocol unlike
the trial split of the batched scripts. As in the reference:

- the node permutation is ``np.random.RandomState(seed=42).permutation``;
- train and val losses come from the same forward pass each epoch, test
  runs (after the optimizer step) when val does not get worse;
- the loss covers ALL label times, t = 0 included.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from gn_ode_sir_tpu_torch.train.checkpoint import tree_leaves, tree_map


def node_split_indices(n_nodes: int, ratios=(0.6, 0.2, 0.2), seed: int = 42):
    """The reference's seeded node permutation split."""
    idx = np.random.RandomState(seed=seed).permutation(n_nodes)
    b1 = int(ratios[0] * n_nodes)
    b2 = int((ratios[0] + ratios[1]) * n_nodes)
    return idx[:b1], idx[b1:b2], idx[b2:]


@dataclasses.dataclass
class NodeSplitResult:
    params: Any
    best_epoch: int
    best_val_loss: float
    test_loss: float
    test_time: float
    history: list  # (epoch, train_loss, val_loss)


def fit_node_split(model, optimizer, params, adj, s0, i0, r0, beta: float, gamma: float,
                   labels, *, idx_train, idx_val, idx_test, epochs: int = 100,
                   verbose: bool = True, log_every: int = 10) -> NodeSplitResult:
    """Train on the node split of one trial's trajectories, on the device
    the params lie on.

    ``optimizer``: a callable ``leaves -> torch.optim.Optimizer``, bound to a
    trained copy of ``params``. ``s0``/``i0``/``r0``: [n] initial state;
    ``labels``: [T, n, 3]."""
    device = next(leaf for _, leaf in tree_leaves(params)).device
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    opt = optimizer([leaf for _, leaf in tree_leaves(params)])
    on = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    xs = (on(s0)[None], on(i0)[None], on(r0)[None], on([beta]), on([gamma]))
    labels = on(labels)
    idx_train, idx_val, idx_test = (on(i, torch.long) for i in (idx_train, idx_val, idx_test))

    def node_loss(pred, idx):
        # mean |.| per channel over (t, selected nodes), averaged over S/I/R
        return (pred[:, idx] - labels[:, idx]).abs().mean(dim=(0, 1)).mean()

    forward = lambda: model.predict(params, adj, *xs)[:, 0]  # [T, n, 3]
    best_val = float("inf")
    best_epoch, test_loss, test_time = -1, float("nan"), 0.0
    history = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        pred = forward()
        train = node_loss(pred, idx_train)
        val = node_loss(pred.detach(), idx_val)
        train.backward()
        opt.step()
        train, val = train.item(), val.item()
        history.append((epoch, train, val))
        if val <= best_val:  # the reference compares with <= here
            best_val = val
            best_epoch = epoch
            with torch.no_grad():
                test_loss = float(node_loss(forward(), idx_test))  # after the update
            test_time = time.perf_counter() - t0
        if verbose and (epoch % log_every == 0 or epoch == epochs - 1):
            print(f"Epoch: {epoch:03d}, Train Loss: {train:.5f}, Val Loss: {val:.5f}")
    return NodeSplitResult(params=tree_map(lambda t: t.detach(), params),
                           best_epoch=best_epoch, best_val_loss=best_val,
                           test_loss=test_loss, test_time=test_time, history=history)
