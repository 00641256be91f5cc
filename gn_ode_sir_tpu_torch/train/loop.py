"""Training loop with the best-val-triggers-test protocol (port of
``gn_ode_sir_tpu.train.loop``).

The JAX package compiles a whole epoch into one ``lax.scan`` over minibatch
index rows; here the scan is a Python loop, one forward, backward and
optimiser step per row. The arithmetic is kept to the letter: each
minibatch contributes ``loss * items`` and ``items`` (the item-weighted mean
of the reference), in float32, and the epoch's loss is the quotient of the
two sums. The val pass runs every epoch; the test pass runs only when
validation improves.

Not ported yet, each raising ``NotImplementedError`` when asked for:
periodic checkpoints and resume (``checkpoint_dir``, ``checkpoint_every``,
``checkpoint_auto_s``, ``resume``: ROADMAP.md Queue 1, train/checkpoint.py +
resume in fit) and ``profile_dir`` (utils/profiling.py). What only the
multigraph and node-split runs use of the reference's ``fit`` — node masks,
``adj_aux``, a separate evaluation connectivity, graph-homogeneous batches —
comes with train/multigraph.py.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from gn_ode_sir_tpu_torch.train.checkpoint import tree_map
from gn_ode_sir_tpu_torch.train.data import TrialData, epoch_batches
from gn_ode_sir_tpu_torch.train.loss import l1_sir_loss


def _data_to_device(data: TrialData, device) -> dict:
    return {k: torch.as_tensor(getattr(data, k), device=device)
            for k in ("s0", "i0", "r0", "beta", "gamma", "labels", "graph_idx")}


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def _batch_loss(model, params, adj_fn, d, bidx, bw, train=False):
    """Loss of one minibatch and its item count (for the item-weighted
    aggregation across minibatches). ``bidx``: [b] long trial indices,
    ``bw``: [b] f32 weights (0 on padding rows)."""
    adj = adj_fn(d["graph_idx"][bidx])
    pred = model.predict(params, adj, d["s0"][bidx], d["i0"][bidx], d["r0"][bidx],
                         d["beta"][bidx], d["gamma"][bidx], train=train)
    loss = l1_sir_loss(pred, d["labels"][bidx], trial_weight=bw)
    items = 3.0 * (d["labels"].shape[1] - 1) * (bw * d["s0"].shape[1]).sum()
    return loss, items


def _leaves(params) -> list:
    out = []
    for v in params.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def make_train_epoch_fn(model, optimizer, adj_fn) -> Callable:
    """Whole-epoch trainer: one optimiser step per minibatch index row.
    ``optimizer`` is a ``torch.optim.Optimizer`` over the leaves of
    ``params``, which it updates in place. Returns the epoch's item-weighted
    mean loss as a 0-d tensor (no host sync inside the epoch)."""

    def train_epoch(params, d, batch_idx, batch_w):
        device = d["beta"].device
        loss_sum = torch.zeros((), device=device)
        item_sum = torch.zeros((), device=device)
        for bidx, bw in zip(_index(batch_idx, device),
                            torch.as_tensor(batch_w, device=device)):
            optimizer.zero_grad(set_to_none=True)
            loss, items = _batch_loss(model, params, adj_fn, d, bidx, bw, train=True)
            loss.backward()
            optimizer.step()
            loss_sum += loss.detach() * items
            item_sum += items
        return loss_sum / item_sum

    return train_epoch


def make_eval_fn(model, adj_fn) -> Callable:
    """Batched evaluation returning the item-weighted mean L1 (0-d tensor)."""

    def evaluate(params, d, batch_idx, batch_w):
        device = d["beta"].device
        loss_sum = torch.zeros((), device=device)
        item_sum = torch.zeros((), device=device)
        with torch.no_grad():
            for bidx, bw in zip(_index(batch_idx, device),
                                torch.as_tensor(batch_w, device=device)):
                loss, items = _batch_loss(model, params, adj_fn, d, bidx, bw)
                loss_sum += loss * items
                item_sum += items
        return loss_sum / item_sum

    return evaluate


def make_eval_per_trial_fn(model, adj_fn) -> Callable:
    """Per-trial evaluation: loss vector [len(idx)], one entry per trial (a
    batch of one each), whatever the training batch size — the per-trial
    test losses that feed the first out-of-dist CSV."""

    def evaluate_per_trial(params, d, idx):
        device = d["beta"].device
        one = torch.ones((1,), device=device)
        with torch.no_grad():
            losses = [_batch_loss(model, params, adj_fn, d, i[None], one)[0]
                      for i in _index(idx, device)]
        return torch.stack(losses) if losses else torch.zeros((0,), device=device)

    return evaluate_per_trial


@dataclasses.dataclass
class FitResult:
    params: Any
    opt_state: Any
    best_epoch: int
    best_val_loss: float
    test_loss: float
    test_time: float
    history: list  # (epoch, train_loss, val_loss)
    epoch_times: list
    test_loss_all: Any = None  # per-trial test losses at the best-val epoch
    best_params: Any = None  # params at the best-val epoch (the weights the
    # reported test_loss was scored with — the serving snapshot)


def fit(
    model,
    optimizer,
    params,
    data: TrialData,
    train_idx,
    val_idx,
    test_idx,
    adj_fn,
    *,
    epochs: int = 500,
    batch_size: int = 1,
    seed: int = 0,
    eval_batch_size: int | None = None,
    verbose: bool = True,
    log_every: int = 50,
    metrics_logger=None,
    profile_dir: str | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    checkpoint_auto_s: float = 0.0,
    resume: bool = False,
    track_test_per_trial: bool = False,
) -> FitResult:
    """Full training protocol over a trial dataset, on the device the
    params lie on.

    ``optimizer``: a callable ``leaves -> torch.optim.Optimizer`` (for
    example ``lambda p: torch.optim.Adam(p, lr=1e-4)``), bound here to the
    trained copy of ``params``; the caller's tensors are left untouched.
    ``adj_fn(graph_idx_batch) -> adjacency`` supplies connectivity per
    minibatch (a constant for single-graph runs). ``seed`` seeds the batch
    shuffle (``numpy.random.default_rng``, the same orders as the JAX
    package).
    """
    if checkpoint_dir or checkpoint_every or checkpoint_auto_s or resume:
        raise NotImplementedError(
            "periodic checkpoints and resume are not ported yet (ROADMAP.md "
            "Queue 1: train/checkpoint.py + resume in fit)")
    if profile_dir is not None:
        raise NotImplementedError(
            "profile_dir is not ported yet (ROADMAP.md Queue 1: utils/profiling.py)")

    device = _leaves(params)[0].device
    # the trained copy: torch optimisers update their tensors in place
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    opt = optimizer(_leaves(params))
    snapshot = lambda: tree_map(lambda t: t.detach().clone(), params)

    d = _data_to_device(data, device)
    train_epoch = make_train_epoch_fn(model, opt, adj_fn)
    evaluate = make_eval_fn(model, adj_fn)
    evaluate_per_trial = make_eval_per_trial_fn(model, adj_fn) if track_test_per_trial else None

    ebs = eval_batch_size or max(batch_size, 8)
    rng = np.random.default_rng(seed)
    val_bi, val_bw = epoch_batches(len(val_idx), ebs, None)
    test_bi, test_bw = epoch_batches(len(test_idx), ebs, None)
    val_bi = np.asarray(val_idx, np.int32)[val_bi]
    test_bi = np.asarray(test_idx, np.int32)[test_bi]

    best_val = float("inf")
    best_epoch = -1
    best_params = snapshot()
    test_loss = float("nan")
    test_loss_all = None
    test_time = 0.0
    history, epoch_times = [], []

    for epoch in range(epochs):
        t0 = time.perf_counter()
        bi, bw = epoch_batches(len(train_idx), batch_size, rng)
        bi = np.asarray(train_idx, np.int32)[bi]
        train_loss = train_epoch(params, d, bi, bw)
        val_loss = float(evaluate(params, d, val_bi, val_bw))  # waits for the device
        epoch_times.append(time.perf_counter() - t0)
        train_loss = float(train_loss)
        history.append((epoch, train_loss, val_loss))
        if metrics_logger is not None:
            metrics_logger.log(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                               epoch_s=epoch_times[-1])

        if val_loss < best_val:
            best_val = val_loss
            best_epoch = epoch
            best_params = snapshot()
            t1 = time.perf_counter()
            test_loss = float(evaluate(params, d, test_bi, test_bw))
            if evaluate_per_trial is not None:
                test_loss_all = evaluate_per_trial(
                    params, d, np.asarray(test_idx, np.int32)).cpu().numpy()
            test_time = time.perf_counter() - t1
        if verbose and (epoch % log_every == 0 or epoch == epochs - 1):
            print(f"Epoch: {epoch:03d}, Train Loss: {train_loss:.10f}, "
                  f"Val Loss: {val_loss:.10f} ({epoch_times[-1]:.3f}s)")

    return FitResult(
        params=tree_map(lambda t: t.detach(), params),
        opt_state=opt.state_dict(),
        best_epoch=best_epoch,
        best_val_loss=best_val,
        test_loss=test_loss,
        test_time=test_time,
        history=history,
        epoch_times=epoch_times,
        test_loss_all=test_loss_all,
        best_params=best_params,
    )
