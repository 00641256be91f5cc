"""Training loop with the best-val-triggers-test protocol (port of
``gn_ode_sir_tpu.train.loop``).

The JAX package compiles a whole epoch into one ``lax.scan`` over minibatch
index rows; here the scan is a Python loop, one forward, backward and
optimiser step per row. The arithmetic is kept to the letter: each
minibatch contributes ``loss * items`` and ``items`` (the item-weighted mean
of the reference), in float32, and the epoch's loss is the quotient of the
two sums. The val pass runs every epoch; the test pass runs only when
validation improves.

Connectivity comes from ``adj_fn(graph_idx) -> adjacency``, where
``graph_idx`` is the minibatch's graph ids as a numpy array on the HOST: the
index rows are built there, so a provider that applies one graph's plan to a
whole minibatch (``train.multigraph.multigraph_pallas2_fns``) reads the id
without asking the device. The JAX package's ``adj_aux`` argument, which
keeps connectivity arrays out of a compiled program, has no counterpart:
the providers close over their device tensors.

Periodic checkpoints of the whole training state (``checkpoint_dir``,
``checkpoint_every``, the auto cadence of ``checkpoint_auto_s``),
exact-trace resume (``resume``) and the profiler trace of a range of epochs
(``profile_dir``, ``profile_epochs``) follow the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from gn_ode_sir_tpu_torch.sim.mc_sir import fold_seed
from gn_ode_sir_tpu_torch.train.checkpoint import (checkpoint_path, restore_checkpoint,
                                                   save_checkpoint, tree_leaves, tree_map)
from gn_ode_sir_tpu_torch.train.data import TrialData, epoch_batches, epoch_batches_grouped
from gn_ode_sir_tpu_torch.train.loss import l1_sir_loss
from gn_ode_sir_tpu_torch.utils.profiling import span, trace


def _data_to_device(data: TrialData, device) -> dict:
    """The trial arrays on ``device``; ``graph_idx`` stays on the host."""
    d = {k: torch.as_tensor(getattr(data, k), device=device)
         for k in ("s0", "i0", "r0", "beta", "gamma", "labels")}
    d["graph_idx"] = np.asarray(data.graph_idx)
    return d


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def _batch_loss(model, params, adj_fn, node_mask_fn, d, bidx, bw, graph_idx, rng=None,
                train=False, n_view=None):
    """Loss of one minibatch and its item count (for the item-weighted
    aggregation across minibatches). ``bidx``: [b] long trial indices,
    ``bw``: [b] f32 weights (0 on padding rows), ``graph_idx``: [b] numpy
    graph ids of those trials.

    ``n_view`` slices the node axis down to the width the adjacency was
    built for (the largest TRAIN graph of a multi-graph run whose unseen
    evaluation graph sets a much larger padding). Rows >= n_view are padding
    for every trial such a program sees (mask 0, label 0), so the numbers are
    the same and only the work shrinks."""
    adj = adj_fn(graph_idx)
    node_mask = None if node_mask_fn is None else node_mask_fn(graph_idx)[:, :n_view]
    pred = model.predict(params, adj, d["s0"][bidx][:, :n_view], d["i0"][bidx][:, :n_view],
                         d["r0"][bidx][:, :n_view], d["beta"][bidx], d["gamma"][bidx],
                         rng=rng, train=train)
    loss = l1_sir_loss(pred, d["labels"][bidx][:, :, :n_view], trial_weight=bw,
                       node_mask=node_mask)
    if node_mask is not None:
        n_eff = node_mask.sum(1)
    else:
        n_eff = n_view if n_view is not None else d["s0"].shape[1]
    items = 3.0 * (d["labels"].shape[1] - 1) * (bw * n_eff).sum()
    return loss, items


def _leaves(params) -> list:
    return [leaf for _, leaf in tree_leaves(params)]


def _rows(d, batch_idx, batch_w):
    """Per minibatch: device index row, device weight row, host graph ids."""
    device = d["beta"].device
    batch_idx = np.asarray(batch_idx, np.int64)
    return zip(_index(batch_idx, device), torch.as_tensor(batch_w, device=device),
               d["graph_idx"][batch_idx])


def make_train_epoch_fn(model, optimizer, adj_fn, node_mask_fn=None, n_view=None) -> Callable:
    """Whole-epoch trainer: one optimiser step per minibatch index row.
    ``optimizer`` is a ``torch.optim.Optimizer`` over the leaves of
    ``params``, which it updates in place. ``epoch_seed`` (an integer) turns
    dropout on: step k draws its masks from a generator seeded with
    ``fold_seed(epoch_seed, k)``. Returns the epoch's item-weighted mean loss
    as a 0-d tensor (no host sync inside the epoch).

    Under a profiler each step shows as three spans, ``train.forward``
    (gathers, adjacency, prediction, loss), ``train.backward`` and
    ``train.optimizer``."""

    def train_epoch(params, d, batch_idx, batch_w, epoch_seed=None):
        device = d["beta"].device
        loss_sum = torch.zeros((), device=device)
        item_sum = torch.zeros((), device=device)
        rng = None if epoch_seed is None else torch.Generator(device=device)
        for k, (bidx, bw, gi) in enumerate(_rows(d, batch_idx, batch_w)):
            if rng is not None:
                rng.manual_seed(fold_seed(epoch_seed, k))
            optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                loss, items = _batch_loss(model, params, adj_fn, node_mask_fn, d, bidx, bw, gi,
                                          rng=rng, train=True, n_view=n_view)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                optimizer.step()
            loss_sum += loss.detach() * items
            item_sum += items
        return loss_sum / item_sum

    return train_epoch


def make_eval_fn(model, adj_fn, node_mask_fn=None, n_view=None) -> Callable:
    """Batched evaluation returning the item-weighted mean L1 (0-d tensor).
    Runs under ``torch.func.vmap`` over stacked params (no in-place
    accumulation), as the ensemble's evaluation calls it."""

    def evaluate(params, d, batch_idx, batch_w):
        device = d["beta"].device
        loss_sum = torch.zeros((), device=device)
        item_sum = torch.zeros((), device=device)
        with torch.no_grad():
            for bidx, bw, gi in _rows(d, batch_idx, batch_w):
                loss, items = _batch_loss(model, params, adj_fn, node_mask_fn, d, bidx, bw, gi,
                                          n_view=n_view)
                loss_sum = loss_sum + loss * items
                item_sum = item_sum + items
        return loss_sum / item_sum

    return evaluate


def make_eval_per_trial_fn(model, adj_fn, node_mask_fn=None, n_view=None) -> Callable:
    """Per-trial evaluation: loss vector [len(idx)], one entry per trial (a
    batch of one each), whatever the training batch size — the per-trial
    test losses that feed the first out-of-dist CSV."""

    def evaluate_per_trial(params, d, idx):
        device = d["beta"].device
        idx = np.asarray(idx).reshape(-1, 1)
        with torch.no_grad():
            losses = [_batch_loss(model, params, adj_fn, node_mask_fn, d, bidx, bw, gi,
                                  n_view=n_view)[0]
                      for bidx, bw, gi in _rows(d, idx, np.ones(idx.shape, np.float32))]
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


def index_batches(idx, graph_idx, size: int, rng, by_graph: bool):
    """Minibatch rows of the trials ``idx`` (absolute indices) and their
    weights: graph-homogeneous with ``by_graph``, shuffled with ``rng``."""
    if by_graph:
        return epoch_batches_grouped(idx, graph_idx, size, rng)
    bi, bw = epoch_batches(len(idx), size, rng)
    return np.asarray(idx, np.int32)[bi], bw


def auto_cadence(checkpoint_dir, checkpoint_every, checkpoint_auto_s, epoch, start_epoch,
                 epochs, epoch_times, verbose) -> int:
    """``checkpoint_every`` after ``epoch``: with ``checkpoint_auto_s`` set and
    no explicit interval, once three epochs have run, the projection of the
    run's time decides whether to save every ~300 s from now on. The steady
    epoch time is the least of the three (the first pays the kernel build and
    the allocator's warm-up)."""
    if not (checkpoint_dir and checkpoint_auto_s and not checkpoint_every
            and epoch == start_epoch + 2):
        return checkpoint_every
    steady_s = float(np.min(epoch_times[-3:]))
    projected = float(np.sum(epoch_times)) + steady_s * (epochs - epoch - 1)
    if projected <= checkpoint_auto_s:
        return checkpoint_every
    every = max(1, int(300.0 / steady_s))
    if verbose:
        print(f"auto-checkpoint: projected {projected / 60:.1f} min run -> saving every "
              f"{every} epochs")
    return every


def final_save_due(checkpoint_dir, epochs, start_epoch, checkpoint_every, ckpt_on_disk,
                   checkpoint_auto_s) -> bool:
    """The end-of-run save: always for an explicitly requested directory,
    but not when only the auto cadence armed it and found the run short —
    unless a state is already on disk (restored or written mid-run), which
    must not stay behind as the directory's truth."""
    return bool(checkpoint_dir and epochs > start_epoch
                and (checkpoint_every or ckpt_on_disk or not checkpoint_auto_s))


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
    node_mask_fn=None,
    eval_adj_fn=None,
    batch_by_graph: bool = False,
    eval_batch_size: int | None = None,
    verbose: bool = True,
    log_every: int = 50,
    metrics_logger=None,
    profile_dir: str | None = None,
    profile_epochs: tuple = (2, 4),
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
    minibatch (a constant for single-graph runs; ``graph_idx_batch`` is a
    numpy array), ``node_mask_fn(graph_idx_batch) -> [b, n]`` the mask of
    real nodes on padded multi-graph batches. ``seed`` seeds the batch
    shuffle (``numpy.random.default_rng``, the same orders as the JAX
    package) and, for a model with dropout, the masks: step k of epoch e
    draws from ``fold_seed(fold_seed(seed + 1, e), k)``.

    ``eval_adj_fn`` (default: ``adj_fn``) lets val/test use another
    connectivity than training — the multi-graph providers build the train
    side at the train graphs' width. ``batch_by_graph=True`` builds
    graph-homogeneous minibatches (``epoch_batches_grouped``), required by
    an ``adj_fn`` that applies one graph's plan to the whole minibatch.

    Checkpoints: with ``checkpoint_dir``, the whole training state is saved
    every ``checkpoint_every`` epochs, or, with ``checkpoint_auto_s``, every
    ~300 s once the first three epochs project the run past that many
    seconds; ``resume=True`` restores ``<checkpoint_dir>/state.pt`` when it
    exists and fast-forwards the shuffle so that the resumed run repeats the
    uninterrupted run's trace exactly. The end of the run saves too, unless
    the auto cadence alone armed the directory and found the run short.

    ``profile_dir``: epochs ``profile_epochs[0]`` through
    ``profile_epochs[1]`` run under :func:`~gn_ode_sir_tpu_torch.utils.trace`,
    which writes their trace into the directory when the range ends (or the
    run does).
    """

    # an adj_fn that reads ONE plan per minibatch declares it: run with
    # mixed-graph batches it would apply the wrong connectivity to most trials
    for f in (adj_fn, eval_adj_fn):
        if (f is not None and getattr(f, "requires_grouped_batches", False)
                and not batch_by_graph):
            raise ValueError(
                f"{getattr(f, '__name__', 'adj_fn')} applies one graph's "
                "plan to the whole minibatch: it requires graph-homogeneous "
                "batches — call fit(..., batch_by_graph=True)"
            )

    # a node-view adjacency is valid only for the graphs it was built for: a
    # trial of a larger graph would silently lose its high rows
    def _check_view(f, idx, which, hint):
        ok_graphs = getattr(f, "valid_train_graphs", None)
        if ok_graphs is None or len(idx) == 0:
            return
        bad = set(int(g) for g in np.asarray(data.graph_idx)[
            np.asarray(idx, np.int64)]) - set(ok_graphs)
        if bad:
            raise ValueError(
                f"{which} contains trials of graphs {sorted(bad)}, but the "
                f"adjacency's node view only covers graphs "
                f"{sorted(ok_graphs)} (the non-eval bucket). {hint}"
            )

    _check_view(adj_fn, train_idx, "train_idx",
                "Pass the protocol train split, or rebuild connectivity "
                "with train_node_view=False.")
    e_adj_fn = eval_adj_fn or adj_fn
    for _idx, _name in ((val_idx, "val_idx"), (test_idx, "test_idx")):
        _check_view(e_adj_fn, _idx, _name,
                    "Pass eval_adj_fn (the full-width adjacency — e.g. "
                    "MultigraphConnectivity.eval_adj_fn / fit_kwargs()), or "
                    "rebuild connectivity with train_node_view=False.")

    device = _leaves(params)[0].device
    # the trained copy: torch optimisers update their tensors in place
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    opt = optimizer(_leaves(params))
    snapshot = lambda: tree_map(lambda t: t.detach().clone(), params)

    d = _data_to_device(data, device)
    # a provider that builds its adjacency below the data's padded width
    # declares the width on the fn; that program then runs at it
    train_epoch = make_train_epoch_fn(model, opt, adj_fn, node_mask_fn,
                                      n_view=getattr(adj_fn, "n_view", None))
    e_n_view = getattr(e_adj_fn, "n_view", None)
    evaluate = make_eval_fn(model, e_adj_fn, node_mask_fn, n_view=e_n_view)
    evaluate_per_trial = (make_eval_per_trial_fn(model, e_adj_fn, node_mask_fn, n_view=e_n_view)
                          if track_test_per_trial else None)

    ebs = eval_batch_size or max(batch_size, 8)
    rng = np.random.default_rng(seed)

    batches = lambda idx, size, rng: index_batches(idx, data.graph_idx, size, rng,
                                                   batch_by_graph)
    val_bi, val_bw = batches(val_idx, ebs, None)
    test_bi, test_bw = batches(test_idx, ebs, None)

    best_val = float("inf")
    best_epoch = -1
    best_params = snapshot()
    test_loss = float("nan")
    test_loss_all = None
    test_time = 0.0
    history, epoch_times = [], []
    start_epoch = 0

    ckpt_on_disk = False  # restored from or written to by this run
    if checkpoint_dir and resume and os.path.exists(checkpoint_path(checkpoint_dir)):
        ckpt_on_disk = True
        st = restore_checkpoint(checkpoint_dir)
        with torch.no_grad():
            for leaf, saved in zip(_leaves(params), _leaves(st["params"])):
                leaf.copy_(saved)
        opt.load_state_dict(st["opt_state"])
        # keys an older state lacks default as the JAX layout ladder's rungs
        best_params = (tree_map(lambda t: t.to(device), st["best_params"])
                       if "best_params" in st else snapshot())
        if track_test_per_trial and "test_loss_all" in st:
            test_loss_all = st["test_loss_all"].numpy()
        start_epoch = int(st["epoch"]) + 1
        best_val = float(st["best_val"])
        best_epoch = int(st["best_epoch"])
        test_loss = float(st["test_loss"])
        test_time = float(st.get("test_time", 0.0))
        # epoch k of the resumed run draws the uninterrupted run's permutation
        # (dropout's stream is indexed by the epoch already)
        for _ in range(start_epoch):
            batches(train_idx, batch_size, rng)
        if verbose:
            print(f"resumed from {checkpoint_dir} at epoch {start_epoch}")

    def save(epoch):
        nonlocal ckpt_on_disk
        ckpt_on_disk = True
        state = {"params": params, "opt_state": opt.state_dict(), "epoch": epoch,
                 "best_val": best_val, "best_epoch": best_epoch, "test_loss": test_loss,
                 "best_params": best_params, "test_time": float(test_time)}
        if track_test_per_trial:
            state["test_loss_all"] = (np.full(len(test_idx), np.nan) if test_loss_all is None
                                      else np.asarray(test_loss_all))
        save_checkpoint(checkpoint_dir, state)

    profiler = contextlib.ExitStack()
    for epoch in range(start_epoch, epochs):
        if profile_dir is not None and epoch == profile_epochs[0]:
            profiler.enter_context(trace(profile_dir))
        t0 = time.perf_counter()
        bi, bw = batches(train_idx, batch_size, rng)
        train_loss = train_epoch(params, d, bi, bw, fold_seed(seed + 1, epoch))
        val_loss = float(evaluate(params, d, val_bi, val_bw))  # waits for the device
        epoch_times.append(time.perf_counter() - t0)
        train_loss = float(train_loss)
        history.append((epoch, train_loss, val_loss))
        if epoch >= profile_epochs[1]:
            profiler.close()
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
        checkpoint_every = auto_cadence(checkpoint_dir, checkpoint_every, checkpoint_auto_s,
                                        epoch, start_epoch, epochs, epoch_times, verbose)
        if checkpoint_dir and checkpoint_every and (epoch + 1) % checkpoint_every == 0:
            save(epoch)

    profiler.close()
    if final_save_due(checkpoint_dir, epochs, start_epoch, checkpoint_every, ckpt_on_disk,
                      checkpoint_auto_s):
        save(epochs - 1)
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
