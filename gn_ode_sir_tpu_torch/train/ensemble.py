"""The K-repeat protocol in one run (port of ``gn_ode_sir_tpu.train.ensemble``).

The reference repeats an experiment as sequential workers that differ only
in the model init (the monitorer's ``hidden_dim_array=[8, 8, 8, 8]``). Here
the K members' params are stacked on a leading member axis [K, ...], one
``torch.optim.Adam`` steps all of them (Adam is elementwise, so that is K
independent Adams sharing a step count), and member j is seeded exactly as
``fit(seed=seeds[j])``: its init from ``torch.Generator().manual_seed
(seeds[j])``, its own ``numpy.random.default_rng(seeds[j])`` shuffle and, for
a model with dropout, its own mask stream from ``fold_seed(seeds[j] + 1,
...)``. Member j's arithmetic is that of the sequential ``fit``: inside the
fold the linear layers run member after member (the ``vmap`` rule of
``models.common.linear``), so member j's losses equal the sequential run's
to the last bit on the CPU.

Two routes for the member axis, chosen from the arguments
(:func:`member_routes`):

- **fold**: the member losses are computed by ``torch.func.vmap`` over the
  stacked params (and over each member's minibatch rows), the member axis a
  real tensor axis. Where all members apply one adjacency, K1 takes every
  member in one launch per field evaluation ([K·B, n, h], the ``vmap`` rule
  of ``ops.spmm2``). ``.backward()`` on the sum of the member losses gives
  each leaf its own member's gradient (the members are independent).
  Evaluation folds (val and test rows are the same for every member);
  training folds when the train trials lie on one graph (one adjacency for
  every member's minibatch), the batches are not grouped by graph, and the
  model draws no dropout. Either folds only while the K members'
  trajectories (``solver_policy``'s estimate, T·3·K·B·n·h·4 bytes) fit the
  activation budget of ``models.gnode.device_activation_budget`` (1/8 of
  the card's memory): at enron size, hidden 64, the evaluation batch of 8
  takes 8.3 GB a member, so four members evaluate one after another while
  their training steps at batch 1 fold. A ``checkpoint`` adjoint trains
  as ``direct`` in the fold: ``torch.utils.checkpoint`` fails under
  ``torch.func.vmap`` (its recomputation sees the functorch-wrapped
  tensors), and the two give the same gradient.
- **per_member**: members run one after another inside the same step, each
  on its own minibatch, before the one optimizer step (the JAX package's
  ``lax.map`` route). It is taken for graph-homogeneous minibatches with one
  K1 plan per graph (member j's minibatch k may lie on another graph than
  member i's), for train trials of several graphs (per-trial adjacency), for
  models that draw dropout from a ``torch.Generator`` (GCN, GIN: ``vmap``
  takes no generator, and each member's mask stream stays its own), for the
  ``backsolve`` adjoint (its autograd Function has no ``vmap`` rule), for
  ``dopri5_adaptive`` (which reads its grid indices back once per solve),
  and where the folded trajectories would not fit the budget.

Scaling out (``mesh``, a :func:`~gn_ode_sir_tpu_torch.parallel.make_mesh`
mesh): the member axis splits over the ``mesh_axis`` group, K a multiple of
its size. Each process trains its own block of members (folded or one by
one, as above) and nothing crosses processes while training; at the end the
members' histories, results, params and optimizer state are all-gathered
over the group, so that every process returns the whole
:class:`EnsembleFitResult` (``epoch_times``, ``test_time`` and ``routes``
are this process's own). ``data_axis`` (a second mesh axis) splits the
trial store's rows over that axis's group as well: each process keeps a
contiguous block of the rows on its device, and the rows a minibatch (or
the val and test passes) reads are assembled by one ``all_reduce(SUM)`` of
zero-filled local rows, which is exact: every row has one non-zero
contributor. The collectives run outside ``torch.func.vmap``. With a mesh,
each process checkpoints into ``<checkpoint_dir>/rank<r>``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gn_ode_sir_tpu_torch.models.gnode import device_activation_budget
from gn_ode_sir_tpu_torch.sim.mc_sir import fold_seed
from gn_ode_sir_tpu_torch.train.checkpoint import (checkpoint_path, restore_checkpoint,
                                                   save_checkpoint, tree_leaves, tree_map)
from gn_ode_sir_tpu_torch.train.data import TrialData
from gn_ode_sir_tpu_torch.train.loop import (_batch_loss, _data_to_device, _index,
                                             auto_cadence, final_save_due, index_batches,
                                             make_eval_fn, make_eval_per_trial_fn)

__all__ = ["EnsembleFitResult", "fit_ensemble", "init_ensemble", "member_routes",
           "trajectory_bytes"]


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def init_ensemble(model, seeds: Sequence[int], *, device) -> dict:
    """K-stacked params: member j initialized as ``fit`` would be with
    ``seed = seeds[j]`` (``model.init(torch.Generator().manual_seed(s))``)."""
    return _stack([model.init(torch.Generator().manual_seed(int(s)), device=device)
                   for s in seeds])


def _member(tree, j):
    return tree_map(lambda t: t[j], tree)


@dataclasses.dataclass
class EnsembleFitResult:
    params: Any  # K-stacked
    opt_state: Any
    best_epoch: np.ndarray  # [K] int
    best_val_loss: np.ndarray  # [K]
    test_loss: np.ndarray  # [K]
    test_time: float  # wall of the last test pass (all K members)
    history: list  # (epoch, train_loss [K], val_loss [K])
    epoch_times: list
    test_loss_all: Any = None  # [K, n_test] per-trial losses at each member's best epoch
    best_params: Any = None  # K-stacked params at each member's best-val epoch
    routes: tuple = ("fold", "fold")  # (training, evaluation), see member_routes


_ROW_KEYS = ("s0", "i0", "r0", "beta", "gamma", "labels")


class _Trials:
    """The trial store on the device; :meth:`take` hands back the store and
    the rows unchanged."""

    def __init__(self, data: TrialData, device):
        self.d = _data_to_device(data, device)

    def take(self, idx):
        return self.d, np.asarray(idx)


class _ShardedTrials:
    """The trial store split over the group of a mesh axis: this process
    keeps rows [lo, hi) on its device. :meth:`take` assembles the rows
    ``idx`` (any shape) into a store of their own with one ``all_reduce`` of
    zero-filled local rows, and returns it with ``idx`` renumbered into it."""

    def __init__(self, data: TrialData, device, mesh, axis: str):
        from gn_ode_sir_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

        n, size = data.num_trials, axis_size(mesh, axis)
        per = -(-n // size)
        self.lo = min(n, axis_index(mesh, axis) * per)
        self.hi = min(n, self.lo + per)
        self.local = {k: torch.as_tensor(getattr(data, k)[self.lo:self.hi], device=device)
                      for k in _ROW_KEYS}
        self.shapes = {k: getattr(data, k).shape[1:] for k in _ROW_KEYS}
        self.graph_idx = np.asarray(data.graph_idx)
        self.group, self.device = axis_group(mesh, axis), device

    def take(self, idx):
        idx = np.asarray(idx)
        rows, where = np.unique(idx.reshape(-1), return_inverse=True)
        widths = [int(np.prod(self.shapes[k])) for k in _ROW_KEYS]
        buf = torch.zeros((rows.size, sum(widths)), device=self.device)
        mine = (rows >= self.lo) & (rows < self.hi)
        pick = torch.as_tensor(rows[mine] - self.lo, dtype=torch.long, device=self.device)
        mine_t = torch.as_tensor(np.flatnonzero(mine), dtype=torch.long, device=self.device)
        off = 0
        for k, width in zip(_ROW_KEYS, widths):
            buf[mine_t, off:off + width] = self.local[k][pick].reshape(-1, width).float()
            off += width
        dist.all_reduce(buf, group=self.group)
        d, off = {}, 0
        for k, width in zip(_ROW_KEYS, widths):
            d[k] = buf[:, off:off + width].reshape(rows.size, *self.shapes[k])
            off += width
        d["graph_idx"] = self.graph_idx[rows]
        return d, where.reshape(idx.shape)


def _draws_dropout(model) -> bool:
    return getattr(getattr(model, "gnn", None), "dropout", 0.0) > 0.0


def trajectory_bytes(model, batch: int, n: int) -> int:
    """``solver_policy``'s estimate of one member's stored trajectory, T·3·B·n·h
    float32 (for a GNN baseline: its layers for the grid)."""
    steps = len(model.ts) if hasattr(model, "ts") else model.max_time
    hidden = getattr(model, "hidden", None) or model.gnn.hidden_dim
    return steps * 3 * batch * n * hidden * 4


def member_routes(model, data: TrialData, train_idx, batch_by_graph: bool, *,
                  members: int = 1, train_bytes: int = 0, eval_bytes: int = 0,
                  budget_bytes: int | None = None) -> tuple:
    """(training route, evaluation route), each 'fold' or 'per_member' (see
    the module docstring). ``train_bytes``/``eval_bytes``: one member's
    trajectory at the training and the evaluation batch
    (:func:`trajectory_bytes`); the fold holds ``members`` of them within
    ``budget_bytes`` (default: no limit)."""
    fits = lambda b: budget_bytes is None or members * b <= budget_bytes
    vmappable = getattr(model, "method", None) != "dopri5_adaptive"
    one_graph = np.unique(np.asarray(data.graph_idx)[np.asarray(train_idx, np.int64)]).size <= 1
    train_fold = (vmappable and getattr(model, "adjoint", None) != "backsolve"
                  and not _draws_dropout(model) and not batch_by_graph and one_graph
                  and fits(train_bytes))
    return ("fold" if train_fold else "per_member",
            "fold" if vmappable and fits(eval_bytes) else "per_member")


def fit_ensemble(
    model,
    optimizer,
    params_stack,
    data: TrialData,
    train_idx,
    val_idx,
    test_idx,
    adj_fn,
    *,
    seeds: Sequence[int],
    epochs: int = 500,
    batch_size: int = 1,
    node_mask_fn=None,
    eval_adj_fn=None,
    batch_by_graph: bool = False,
    eval_batch_size: int | None = None,
    verbose: bool = True,
    log_every: int = 50,
    metrics_logger=None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    checkpoint_auto_s: float = 0.0,
    resume: bool = False,
    track_test_per_trial: bool = False,
    mesh=None,
    mesh_axis: str = "ensemble",
    data_axis: str | None = None,
) -> EnsembleFitResult:
    """Train K members (one per entry of ``seeds``) together, each with
    :func:`~gn_ode_sir_tpu_torch.train.fit`'s protocol: the connectivity
    conventions, grouped batching, best-val-triggers-test, periodic and
    auto checkpoints with exact-trace resume, and, with
    ``track_test_per_trial``, each member's per-trial test losses.
    ``optimizer``: ``leaves -> torch.optim.Optimizer``, bound to the trained
    copy of the stacked leaves. Metrics are logged as the members' means.
    ``mesh``/``mesh_axis``/``data_axis``: see the module docstring."""
    if data_axis is not None:
        if mesh is None:
            raise ValueError("data_axis requires a mesh — without one the trial store "
                             "cannot shard; drop data_axis or pass mesh=")
        if data_axis == mesh_axis or data_axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"data_axis {data_axis!r} must name a mesh axis distinct from "
                             f"mesh_axis {mesh_axis!r} (mesh has {mesh.mesh_dim_names})")
    K = len(seeds)
    lead = next(leaf for _, leaf in tree_leaves(params_stack)).shape[0]
    if lead != K:
        raise ValueError(f"params_stack leading axis {lead} != len(seeds) {K} — build it "
                         "with init_ensemble(model, seeds)")
    if mesh is not None:
        from gn_ode_sir_tpu_torch.parallel.mesh import axis_size, local_block

        size = axis_size(mesh, mesh_axis)
        if K % size:
            raise ValueError(f"ensemble size {K} not divisible by mesh axis '{mesh_axis}' "
                             f"of size {size}")
        mine = local_block(K, mesh, mesh_axis)
        seeds = list(seeds)[mine]
        params_stack = tree_map(lambda t: t[mine], params_stack)
        K = len(seeds)
        if checkpoint_dir:
            checkpoint_dir = os.path.join(checkpoint_dir, f"rank{dist.get_rank()}")
    e_adj_fn = eval_adj_fn or adj_fn
    for f in (adj_fn, eval_adj_fn):
        if (f is not None and getattr(f, "requires_grouped_batches", False)
                and not batch_by_graph):
            raise ValueError(
                f"{getattr(f, '__name__', 'adj_fn')} applies one graph's plan to the whole "
                "minibatch: it requires graph-homogeneous batches — call "
                "fit_ensemble(..., batch_by_graph=True)")
    for f, idx, which in ((adj_fn, train_idx, "train_idx"), (e_adj_fn, val_idx, "val_idx"),
                          (e_adj_fn, test_idx, "test_idx")):
        ok_graphs = getattr(f, "valid_train_graphs", None)
        if ok_graphs is not None and len(idx):
            bad = set(int(g) for g in np.asarray(data.graph_idx)[
                np.asarray(idx, np.int64)]) - set(ok_graphs)
            if bad:
                raise ValueError(
                    f"{which} contains trials of graphs {sorted(bad)}, but the adjacency's "
                    f"node view only covers graphs {sorted(ok_graphs)}")

    ebs = eval_batch_size or max(batch_size, 8)
    n_view = getattr(adj_fn, "n_view", None)
    e_n_view = getattr(e_adj_fn, "n_view", None)
    width = data.s0.shape[1]
    device = next(leaf for _, leaf in tree_leaves(params_stack)).device
    train_route, eval_route = member_routes(
        model, data, train_idx, batch_by_graph, members=K,
        train_bytes=trajectory_bytes(model, batch_size, n_view or width),
        eval_bytes=trajectory_bytes(model, ebs, e_n_view or width),
        budget_bytes=device_activation_budget(device))
    # the fold trains through vmap, where torch.utils.checkpoint fails; direct
    # gives the same gradient
    fold_model = (dataclasses.replace(model, adjoint="direct")
                  if getattr(model, "adjoint", None) == "checkpoint" else model)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params_stack)
    leaves = [leaf for _, leaf in tree_leaves(params)]
    opt = optimizer(leaves)
    snapshot = lambda: tree_map(lambda t: t.detach().clone(), params)
    trials = (_ShardedTrials(data, device, mesh, data_axis) if data_axis is not None
              else _Trials(data, device))

    evaluate1 = make_eval_fn(model, e_adj_fn, node_mask_fn, n_view=e_n_view)
    per_trial1 = (make_eval_per_trial_fn(model, e_adj_fn, node_mask_fn, n_view=e_n_view)
                  if track_test_per_trial else None)

    def over_members(fn, *args):
        """fn(one member's params, *args) for every member -> stacked [K, ...]."""
        if eval_route == "fold":
            return torch.func.vmap(lambda p: fn(p, *args))(params)
        return torch.stack([fn(_member(params, j), *args) for j in range(K)])

    def train_epoch(bi, bw, epoch):
        """One optimizer step per minibatch row for all members; returns the
        members' item-weighted mean losses [K]."""
        epoch_seeds = [fold_seed(int(s) + 1, epoch) for s in seeds]
        rng = torch.Generator(device=device)
        w_t = torch.as_tensor(bw, device=device)
        gids = np.asarray(data.graph_idx)[np.asarray(bi, np.int64)]
        loss_sum = torch.zeros(K, device=device)
        item_sum = torch.zeros(K, device=device)
        for k in range(bi.shape[1]):
            d, rows = trials.take(bi[:, k])  # the members' rows of step k, [K, b]
            idx_k = _index(rows, device)
            opt.zero_grad(set_to_none=True)
            if train_route == "fold":
                # every member's rows lie on the one train graph: member 0's
                # graph ids pick the adjacency for all of them
                member_loss = lambda p, bidx, w: _batch_loss(
                    fold_model, p, adj_fn, node_mask_fn, d, bidx, w, gids[0, k],
                    train=True, n_view=n_view)
                losses, items = torch.func.vmap(member_loss)(params, idx_k, w_t[:, k])
                losses.sum().backward()
            else:
                losses, items = [], []
                for j in range(K):
                    rng.manual_seed(fold_seed(epoch_seeds[j], k))
                    loss, it = _batch_loss(model, _member(params, j), adj_fn, node_mask_fn, d,
                                           idx_k[j], w_t[j, k], gids[j, k], rng=rng,
                                           train=True, n_view=n_view)
                    loss.backward()
                    losses.append(loss.detach())
                    items.append(it)
                losses, items = torch.stack(losses), torch.stack(items)
            opt.step()
            loss_sum += losses.detach() * items
            item_sum += items
        return loss_sum / item_sum

    rngs = [np.random.default_rng(int(s)) for s in seeds]

    batches = lambda idx, size, rng: index_batches(idx, data.graph_idx, size, rng,
                                                   batch_by_graph)

    def epoch_batches_stacked():
        rows = [batches(train_idx, batch_size, rng) for rng in rngs]
        return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])

    val_bi, val_bw = batches(val_idx, ebs, None)
    test_bi, test_bw = batches(test_idx, ebs, None)
    # the val and test rows, assembled once (a sharded store gathers them here)
    d_val, val_bi = trials.take(val_bi)
    d_test, test_bi = trials.take(test_bi)
    d_trial, test_idx_arr = trials.take(np.asarray(test_idx, np.int32))

    best_val = np.full(K, np.inf)
    best_epoch = np.full(K, -1, np.int64)
    best_params = snapshot()
    test_loss = np.full(K, np.nan)
    test_loss_all = None  # [K, n_test] once tracked
    test_time = 0.0
    history, epoch_times = [], []
    start_epoch = 0

    ckpt_on_disk = False
    if checkpoint_dir and resume and os.path.exists(checkpoint_path(checkpoint_dir)):
        ckpt_on_disk = True
        st = restore_checkpoint(checkpoint_dir)
        with torch.no_grad():
            for leaf, saved in zip(leaves, (v for _, v in tree_leaves(st["params"]))):
                leaf.copy_(saved)
        opt.load_state_dict(st["opt_state"])
        # keys an older state lacks default as the JAX layout ladder's rungs
        best_params = (tree_map(lambda t: t.to(device), st["best_params"])
                       if "best_params" in st else snapshot())
        if track_test_per_trial and "test_loss_all" in st:
            test_loss_all = st["test_loss_all"].numpy()
        start_epoch = int(st["epoch"]) + 1
        best_val = st["best_val"].numpy()
        best_epoch = st["best_epoch"].numpy()
        test_loss = st["test_loss"].numpy()
        test_time = float(st.get("test_time", 0.0))
        for _ in range(start_epoch):  # every member's shuffle, fast-forwarded
            epoch_batches_stacked()
        if verbose:
            print(f"resumed ensemble from {checkpoint_dir} at epoch {start_epoch}")

    def save(epoch):
        nonlocal ckpt_on_disk
        ckpt_on_disk = True
        state = {"params": params, "opt_state": opt.state_dict(), "epoch": epoch,
                 "best_val": best_val, "best_epoch": best_epoch, "test_loss": test_loss,
                 "best_params": best_params, "test_time": float(test_time)}
        if track_test_per_trial:
            state["test_loss_all"] = (np.full((K, len(test_idx)), np.nan)
                                      if test_loss_all is None else np.asarray(test_loss_all))
        save_checkpoint(checkpoint_dir, state)

    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        bi, bw = epoch_batches_stacked()
        train_l = train_epoch(bi, bw, epoch)
        val_l = over_members(evaluate1, d_val, val_bi, val_bw).cpu().numpy()
        epoch_times.append(time.perf_counter() - t0)
        train_l = train_l.cpu().numpy()
        history.append((epoch, train_l, val_l))
        if metrics_logger is not None:
            metrics_logger.log(epoch=epoch, train_loss=float(train_l.mean()),
                               val_loss=float(val_l.mean()), epoch_s=epoch_times[-1])

        improved = val_l < best_val
        if improved.any():
            best_val = np.where(improved, val_l, best_val)
            best_epoch = np.where(improved, epoch, best_epoch)
            imp = torch.as_tensor(improved, device=device)
            best_params = _select(imp, params, best_params)
            t1 = time.perf_counter()
            test_all = over_members(evaluate1, d_test, test_bi, test_bw).cpu().numpy()
            test_time = time.perf_counter() - t1
            test_loss = np.where(improved, test_all, test_loss)
            if per_trial1 is not None:
                per_trial = over_members(per_trial1, d_trial, test_idx_arr).cpu().numpy()
                if test_loss_all is None:
                    test_loss_all = np.full((K, len(test_idx)), np.nan)
                test_loss_all = np.where(improved[:, None], per_trial, test_loss_all)
        if verbose and (epoch % log_every == 0 or epoch == epochs - 1):
            tr_s = "/".join(f"{x:.10f}" for x in train_l)
            va_s = "/".join(f"{x:.10f}" for x in val_l)
            print(f"Epoch: {epoch:03d}, Train Loss: {tr_s}, Val Loss: {va_s} "
                  f"({epoch_times[-1]:.3f}s)")
        checkpoint_every = auto_cadence(checkpoint_dir, checkpoint_every, checkpoint_auto_s,
                                        epoch, start_epoch, epochs, epoch_times, verbose)
        if checkpoint_dir and checkpoint_every and (epoch + 1) % checkpoint_every == 0:
            save(epoch)

    if final_save_due(checkpoint_dir, epochs, start_epoch, checkpoint_every, ckpt_on_disk,
                      checkpoint_auto_s):
        save(epochs - 1)
    result = EnsembleFitResult(
        params=tree_map(lambda t: t.detach(), params), opt_state=opt.state_dict(),
        best_epoch=best_epoch, best_val_loss=best_val, test_loss=test_loss,
        test_time=test_time, history=history, epoch_times=epoch_times,
        test_loss_all=test_loss_all, best_params=best_params,
        routes=(train_route, eval_route))
    if mesh is not None:
        from gn_ode_sir_tpu_torch.parallel.mesh import axis_group, mesh_device

        result = _gather_members(result, axis_group(mesh, mesh_axis), mesh_device(mesh),
                                 len(test_idx) if track_test_per_trial else None)
    return result


def _gather_members(res: EnsembleFitResult, group, device, n_test) -> EnsembleFitResult:
    """Every process's members, all-gathered over ``group`` in member order:
    the whole K-member result on every process."""

    def cat(x, dim=0):
        t = torch.as_tensor(x).to(device).contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts, dim=dim)
        return out if isinstance(x, torch.Tensor) else out.cpu().numpy()

    stacked = lambda tree: tree_map(lambda t: cat(t).to(t.device), tree)
    history = res.history
    if history:
        train = cat(np.stack([h[1] for h in history]), dim=1)
        val = cat(np.stack([h[2] for h in history]), dim=1)
        history = [(h[0], train[e], val[e]) for e, h in enumerate(history)]
    opt_state = dict(res.opt_state)
    opt_state["state"] = {i: {k: cat(v).to(v.device) if v.dim() else v
                              for k, v in st.items()}
                          for i, st in res.opt_state["state"].items()}
    test_loss_all = None
    if n_test is not None:
        local = (np.full((len(res.best_epoch), n_test), np.nan) if res.test_loss_all is None
                 else np.asarray(res.test_loss_all))
        test_loss_all = cat(local)
        if np.isnan(test_loss_all).all():  # no member improved anywhere
            test_loss_all = None
    return dataclasses.replace(
        res, params=stacked(res.params), best_params=stacked(res.best_params),
        opt_state=opt_state, best_epoch=cat(res.best_epoch),
        best_val_loss=cat(res.best_val_loss), test_loss=cat(res.test_loss),
        history=history, test_loss_all=test_loss_all)


def _select(mask, new, old):
    """Member-wise ``new`` where ``mask`` [K] is set, else ``old``."""
    if isinstance(new, dict):
        return {k: _select(mask, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return [_select(mask, a, b) for a, b in zip(new, old)]
    m = mask.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(m, new.detach(), old)
