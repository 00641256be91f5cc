"""L1 (MAE) loss on S/I/R probability trajectories (port of
``gn_ode_sir_tpu.train.loss``).

The criterion is the mean absolute error over predictions at t >= 1,
item-weighted when aggregating across batches, with optional per-trial
weights (for padded batches) and per-node masks (for padded multi-graph
nodes).
"""

from __future__ import annotations

import torch


def masked_l1(pred, target, weight=None, eps: float = 1e-12):
    """Mean |pred - target| where weight broadcasts over trailing axes."""
    err = (pred - target).abs()
    if weight is None:
        return err.mean()
    w = weight.expand_as(err)
    return (err * w).sum() / (w.sum() + eps)


def l1_sir_loss_sums(pred_tbnc, labels_btnc, trial_weight=None, node_mask=None):
    """Weighted |error| numerator and weight-sum denominator, unreduced, so
    that distributed callers can sum each across shards and then divide."""
    pred = pred_tbnc.permute(1, 0, 2, 3)[:, 1:]
    target = labels_btnc[:, 1:]
    err = (pred - target).abs()
    weight = None
    if trial_weight is not None:
        weight = trial_weight[:, None, None, None]
    if node_mask is not None:
        nm = node_mask[:, None, :, None]
        weight = nm if weight is None else weight * nm
    if weight is None:
        return err.sum(), torch.tensor(err.numel(), dtype=err.dtype, device=err.device)
    w = weight.expand_as(err)
    return (err * w).sum(), w.sum()


def l1_sir_loss(pred_tbnc, labels_btnc, trial_weight=None, node_mask=None):
    """MAE over t >= 1.

    Args:
      pred_tbnc: [T, B, n, 3] model probabilities (time-major model output).
      labels_btnc: [B, T, n, 3] MC labels (trial-major, the dataset layout).
      trial_weight: optional [B] (0 for padding trials in a padded batch).
      node_mask: optional [B, n] (0 for padding nodes in multi-graph batches).
    """
    num, den = l1_sir_loss_sums(pred_tbnc, labels_btnc,
                                trial_weight=trial_weight, node_mask=node_mask)
    if trial_weight is None and node_mask is None:
        return num / den  # exact mean: size > 0
    return num / (den + 1e-12)  # masked_l1's zero-weight guard
