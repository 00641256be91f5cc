"""Data-parallel training steps, edge-sharded SpMM and sharded serving (port
of ``gn_ode_sir_tpu.parallel.spmd``).

One process per device. Where the JAX package splits a global batch inside
``shard_map`` and reduces with ``psum``, each process here takes its own
contiguous block of the global batch (every process passes the same batch)
and reduces with ``torch.distributed`` collectives over the group of one
mesh axis.

Data parallelism: each process computes the loss numerator, the weight-sum
denominator and the numerator's gradient on its block; the global loss is
``all_reduce(num) / all_reduce(den)`` and every gradient of
``num / all_reduce(den)`` is all-reduced over the data group, so the step
equals the single-device step on the whole batch whatever the split of
weights and padding.

Edge parallelism: the dst-sorted edge list is cut into contiguous blocks,
one per process of the edge axis (a hub row may straddle two blocks). Each
process applies K1 on its block's own plan — its plain version on a CPU
tensor — and the partial node sums are all-reduced over the edge group; the
backward is K1-bwd on the block's transpose plan, all-reduced the same way,
so that every (replicated) computation upstream receives the whole gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from gn_ode_sir_tpu_torch.ops import spmm2 as spmm2_module
from gn_ode_sir_tpu_torch.ops.adjacency import CooAdj
from gn_ode_sir_tpu_torch.ops.spmm2 import Spmm2Adj
from gn_ode_sir_tpu_torch.parallel.mesh import (axis_group, axis_index, local_block,
                                                mesh_device)
from gn_ode_sir_tpu_torch.sim.mc_sir import fold_seed
from gn_ode_sir_tpu_torch.train.checkpoint import tree_leaves
from gn_ode_sir_tpu_torch.train.loss import l1_sir_loss_sums


class _EdgeShardedSpmm(torch.autograd.Function):
    """The partial product of one edge block, all-reduced over the edge
    group; its backward all-reduces the input cotangent the same way. ``dw``
    (for the block's own weights, not reduced) only where ``w`` requires a
    gradient."""

    @staticmethod
    def forward(ctx, x, w, adj):
        ctx.adj = adj
        ctx.save_for_backward(x if w.requires_grad else None)
        adj.sync_plans()
        y = adj.local_product(x.contiguous(), transpose=False)
        dist.all_reduce(y, group=adj.group)
        return y

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = adj.local_product(g, transpose=True)
            dist.all_reduce(dx, group=adj.group)
        if ctx.needs_input_grad[1]:
            (x,) = ctx.saved_tensors
            dw = adj.local_dw(x, g)
        return dx, dw, None


@dataclasses.dataclass(frozen=True)
class EdgeShardedCooAdj:
    """Adjacency over this process's block of an edge list, a drop-in for
    :class:`~gn_ode_sir_tpu_torch.ops.adjacency.CooAdj`: a model built on
    ``adj.matvec`` becomes edge-parallel without change.

    ``src``/``dst``/``w`` are the block, [E_local] (one graph shared by the
    batch: K1 on ``plans``, built by :meth:`from_local`) or [B, E_local]
    (per-sample padded rows of a multi-graph batch: the per-sample gather
    and ``index_add`` of ``CooAdj``). ``group``: the edge axis's process
    group (None: the whole world)."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    n_nodes: int
    group: object = None
    plans: Spmm2Adj | None = None
    perms: tuple | None = None  # block edge of each plan edge, (plan, plan_t)
    _w_seen: list = dataclasses.field(default_factory=lambda: [None], compare=False,
                                      repr=False)

    @staticmethod
    def from_local(src, dst, w, n_nodes: int, group=None, *, device) -> "EdgeShardedCooAdj":
        """The adjacency of one block. A shared [E_local] block gets its K1
        plan and transpose plan (built on the host from the block's edges in
        dst order, so zero-weight padding edges may sit anywhere). A ``w``
        tensor is kept as it is: the plans' copies of it follow its updates
        in place (see :meth:`sync_plans`), and where it requires a gradient it
        gets one. A numpy ``w`` is copied once, here."""
        s, d = _host(src), _host(dst)
        w = (w.to(device=device, dtype=torch.float32) if isinstance(w, torch.Tensor)
             else torch.tensor(np.asarray(w, np.float32), device=device))
        as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
        plans = perms = None
        if s.ndim == 1:
            order = np.argsort(d, kind="stable")
            plans = Spmm2Adj.from_edges(s[order], d[order], n_nodes, _host(w)[order],
                                        device=device)
            # Spmm2Adj.from_edges orders the transpose plan by a stable src sort
            perms = (as_long(order), as_long(order[np.argsort(s[order], kind="stable")]))
        adj = EdgeShardedCooAdj(as_long(s), as_long(d), w, int(n_nodes), group, plans, perms)
        adj._w_seen[0] = adj._w_version()
        return adj

    def _w_version(self):
        # an inference tensor has no version counter: None, read at every apply
        return None if self.w.is_inference() else (self.w.data_ptr(), self.w._version)

    def sync_plans(self) -> None:
        """Bring the plans' copies of ``w`` (each in its plan's edge order) up
        to date where ``w`` has changed since they were written: every update
        in place (an optimizer's step) bumps its version counter."""
        seen = self._w_version()
        if self.plans is None or (seen is not None and seen == self._w_seen[0]):
            return
        with torch.no_grad():
            for plan, perm in zip((self.plans.plan, self.plans.plan_t), self.perms):
                torch.index_select(self.w.detach(), 0, perm, out=plan.w)
        self._w_seen[0] = seen

    def local_product(self, x: torch.Tensor, transpose: bool) -> torch.Tensor:
        """This block's (or its transpose's) share of A·x, not yet reduced."""
        if self.plans is not None:
            plan = self.plans.plan_t if transpose else self.plans.plan
            return spmm2_module._apply(plan, x, "f32", backward=transpose)
        src, dst = (self.dst, self.src) if transpose else (self.src, self.dst)
        return CooAdj(src, dst, self.w.detach(), self.n_nodes).matvec(x)

    def local_dw(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """d(sum g·A x)/dw of the block's edges: x[src]·g[dst] summed over the
        width, and over the batch for shared edges."""
        if self.src.dim() == 1:
            return (x[:, self.src, :] * g[:, self.dst, :]).sum(dim=(0, 2))
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        return (x[rows, self.src] * g[rows, self.dst]).sum(-1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _EdgeShardedSpmm.apply(x, self.w, self)


def spmm_edge_sharded(src_local, dst_local, x, n_nodes: int, group=None, w_local=None):
    """Edge-sharded SpMM: this process holds a block of the edge list, ``x``
    [B, n, h] is the same on every process of ``group`` (the edge axis's
    process group; None: the world). Returns the full [B, n, h] aggregate on
    every process, differentiable in ``x`` (and in ``w_local`` where it
    requires a gradient). Builds the block's plans on each call: hold an
    :class:`EdgeShardedCooAdj` to apply one block many times."""
    if w_local is None:
        w_local = torch.ones(np.shape(src_local), dtype=torch.float32, device=x.device)
    return EdgeShardedCooAdj.from_local(src_local, dst_local, w_local, n_nodes, group,
                                        device=x.device).matvec(x)


_ROW_KEYS = ("s0", "i0", "r0", "beta", "gamma", "weight", "labels")


def _default_batch_keys(batch):
    """Fill the optional trial-batch keys with their neutral defaults: a
    missing ``weight`` means equal-weighted trials, a missing ``graph_idx``
    the single-graph protocol."""
    n = len(batch["beta"])
    if "weight" not in batch:
        batch = dict(batch, weight=np.ones(n, np.float32))
    if "graph_idx" not in batch:
        batch = dict(batch, graph_idx=np.zeros(n, np.int32))
    return batch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _local_rows(batch, keys, mesh, axis, device) -> dict:
    """This process's block of the global batch: the trial rows on
    ``device``, ``graph_idx`` as host numpy (what an ``adj_fn`` takes)."""
    sl = local_block(len(batch["beta"]), mesh, axis)
    out = {k: torch.as_tensor(batch[k][sl], dtype=torch.float32, device=device)
           for k in keys if k in batch}
    out["graph_idx"] = _host(batch["graph_idx"])[sl]
    return out


def _build_spmd_step(model, mesh, data_axis: str, connect: Callable,
                     dropout_rng: bool = False, n_view: int | None = None) -> Callable:
    """The shared core of every training-step builder; ``connect(batch,
    *extra) -> (adj, node_mask)`` is the only part the variants differ in.

    The global item-weighted mean is all_reduce(num) / all_reduce(den)
    (a mean of per-shard means would be wrong wherever weights or padding
    spread unevenly); each process differentiates num / all_reduce(den), so
    that one process alone computes the single-device step's arithmetic, and
    gradients are then summed over ``data_axis`` only: where
    connectivity is edge-sharded, :class:`EdgeShardedCooAdj`'s backward has
    already summed them over the edge axis. ``dropout_rng=True`` takes a
    trailing integer seed and runs the forward with ``train=True`` and a
    generator seeded with ``fold_seed(seed, data index)``, so that each data
    shard draws its own masks. ``n_view`` narrows the node axis as ``fit``
    does for a provider built below the batch's padded width."""
    group = axis_group(mesh, data_axis)
    device = mesh_device(mesh)

    def step(params, optimizer, batch, *extra):
        kw = {}
        if dropout_rng:
            *extra, seed = extra
            rng = torch.Generator(device=device)
            rng.manual_seed(fold_seed(int(seed), axis_index(mesh, data_axis)))
            kw = {"rng": rng, "train": True}
        b = _local_rows(_default_batch_keys(batch), _ROW_KEYS, mesh, data_axis, device)
        adj, node_mask = connect(b, *extra)
        if n_view is not None:
            b = {k: v[:, :n_view] if k in ("s0", "i0", "r0") else v for k, v in b.items()}
            b["labels"] = b["labels"][:, :, :n_view]
            node_mask = None if node_mask is None else node_mask[:, :n_view]
        optimizer.zero_grad(set_to_none=True)
        pred = model.predict(params, adj, b["s0"], b["i0"], b["r0"], b["beta"], b["gamma"],
                             **kw)
        num, den = l1_sir_loss_sums(pred, b["labels"], trial_weight=b["weight"],
                                    node_mask=node_mask)
        # the weight sum does not depend on the params: reduce it (with the
        # numerator, for the loss) before the backward, which then divides
        # as the single-device loss does
        sums = torch.stack([num.detach(), den.detach().to(num.dtype)])
        dist.all_reduce(sums, group=group)
        (num / sums[1]).backward()
        for _, leaf in tree_leaves(params):
            if leaf.grad is not None:
                dist.all_reduce(leaf.grad, group=group)
        optimizer.step()
        return sums[0] / sums[1]

    return step


def make_spmd_train_step(model, adj_fn, mesh, axis: str = "data", aux_example=None,
                         node_mask_fn=None, dropout_rng: bool = False) -> Callable:
    """Data-parallel training step: the batch split over ``axis``, the params
    the same on every process. Returns ``step(params, optimizer, batch) ->
    loss``: ``params`` is the port's leaf dict (leaves that require a
    gradient), ``optimizer`` a ``torch.optim`` optimizer bound to its leaves
    (as ``fit`` binds one), which the step zeroes, fills and steps; the
    JAX package's ``opt_state`` is the optimizer's own state. ``batch`` is
    the global minibatch dict (numpy or tensors): s0/i0/r0 [B, n],
    beta/gamma/weight [B], labels [B, T, n, 3], graph_idx [B], with B
    divisible by the axis size; missing ``weight``/``graph_idx`` default to
    equal weights and graph 0.

    ``adj_fn(graph_idx)`` and ``node_mask_fn(graph_idx)`` take the local
    block's graph ids as host numpy, as ``fit``'s do: a K1 provider that
    applies one graph's plan (``multigraph_pallas2_fns``) needs each block
    to lie on one graph, and a provider's ``n_view`` narrows the node axis,
    as in ``fit``. With
    ``aux_example`` (the JAX package's connectivity argument) the step is
    ``step(params, optimizer, batch, aux)`` and both take ``(graph_idx,
    aux)``. ``dropout_rng=True`` (GCN/GIN): the step takes a trailing integer
    seed, see :func:`_build_spmd_step`."""
    n_extra = int(aux_example is not None)
    grouped = getattr(adj_fn, "requires_grouped_batches", False)

    def connect(b, *extra):
        if len(extra) != n_extra:
            raise TypeError(f"the step takes {n_extra} connectivity argument(s) after the "
                            f"batch, got {len(extra)}")
        gi = b["graph_idx"]
        if grouped and np.unique(gi).size > 1:
            raise ValueError(f"{getattr(adj_fn, '__name__', 'adj_fn')} applies one graph's "
                             f"plan to the whole block, which holds graphs {np.unique(gi)}")
        mask = None if node_mask_fn is None else node_mask_fn(gi, *extra)
        return adj_fn(gi, *extra), mask

    return _build_spmd_step(model, mesh, axis, connect, dropout_rng,
                            n_view=getattr(adj_fn, "n_view", None))


class _BlockCache:
    """The last edge block's adjacency, rebuilt only when the step is handed
    an edge list of other contents (plans are host work). It compares with
    its own copy of the last list, so that a list changed in place between
    two steps is seen."""

    def __init__(self):
        self.arrays, self.adj = None, None

    def get(self, arrays, build):
        host = tuple(_host(a) for a in arrays)
        if self.arrays is None or not all(np.array_equal(a, b)
                                          for a, b in zip(host, self.arrays)):
            self.arrays = tuple(np.array(a) for a in host)
            self.adj = build(*self.arrays)
        return self.adj


def make_spmd_train_step_2d(model, mesh, n_nodes: int, data_axis: str = "data",
                            edge_axis: str = "edge", dropout_rng: bool = False) -> Callable:
    """Data x edge-parallel training step over a 2-D mesh: the trial batch is
    split over ``data_axis`` and the dst-sorted edge list over ``edge_axis``;
    message passing runs through :class:`EdgeShardedCooAdj` (K1 on the
    block's plan). Returns ``step(params, optimizer, batch, src, dst, w)``
    with the whole edge list as (src [E], dst [E], w [E]), E divisible by the
    edge-axis size (pad with zero-weight edges)."""
    device = mesh_device(mesh)
    cache = _BlockCache()

    def build(src, dst, w):
        sl = local_block(len(src), mesh, edge_axis)
        return EdgeShardedCooAdj.from_local(src[sl], dst[sl], w[sl], n_nodes,
                                            axis_group(mesh, edge_axis), device=device)

    def connect(b, src, dst, w):
        return cache.get((src, dst, w), build), None

    return _build_spmd_step(model, mesh, data_axis, connect, dropout_rng)


def make_spmd_multigraph_train_step_2d(model, mesh, n_nodes: int, aux_example,
                                       node_mask_fn=None, data_axis: str = "data",
                                       edge_axis: str = "edge",
                                       dropout_rng: bool = False) -> Callable:
    """Data x edge-parallel training step with per-sample multi-graph
    connectivity: trials split over ``data_axis`` and every graph's padded
    edge row over ``edge_axis``, so that no process holds a whole graph's
    edge list. ``aux_example`` names the connectivity dict the step takes:
    src/dst/w [G, E] (E divisible by the edge-axis size; the padded rows of
    a ``GraphBatch``) and whatever ``node_mask_fn(graph_idx, aux)`` reads.
    Each process gathers its trials' rows of its edge block, [B_local,
    E_local]. Returns ``step(params, optimizer, batch, aux)``."""
    missing = {"src", "dst", "w"} - set(aux_example)
    if missing:
        raise ValueError(f"aux_example lacks {sorted(missing)}")
    device = mesh_device(mesh)

    def connect(b, aux):
        gi = b["graph_idx"]
        sl = local_block(np.shape(aux["src"])[1], mesh, edge_axis)
        rows = lambda k: _host(aux[k])[gi][:, sl]
        adj = EdgeShardedCooAdj.from_local(rows("src"), rows("dst"), rows("w"), n_nodes,
                                           axis_group(mesh, edge_axis), device=device)
        mask = None if node_mask_fn is None else node_mask_fn(gi, aux)
        return adj, mask

    return _build_spmd_step(model, mesh, data_axis, connect, dropout_rng)


def make_spmd_predict_fn(model, adj_fn, mesh, axis: str = "data", aux_example=None,
                         node_mask_fn=None, reduce_fn=None) -> Callable:
    """Data-parallel batched inference, the serving path: each process
    predicts its block of the scenarios, applies the node mask and the
    per-scenario ``reduce_fn`` locally, and the blocks are all-gathered, so
    that every process returns the whole result: [T, B, n, 3], or [B, k]
    with ``reduce_fn`` (``[T, b, n, 3] -> [b, k]``; called as ``reduce_fn(
    pred, mask)`` when ``node_mask_fn`` is given). Conventions as in
    :func:`make_spmd_train_step`: ``predict(params, batch[, aux])`` with
    s0/i0/r0 [B, n], beta/gamma [B] and optional graph_idx [B], B divisible
    by the axis size."""
    group = axis_group(mesh, axis)
    device = mesh_device(mesh)
    n_extra = int(aux_example is not None)

    def predict(params, batch, *extra):
        if len(extra) != n_extra:
            raise TypeError(f"predict takes {n_extra} connectivity argument(s) after the "
                            f"batch, got {len(extra)}")
        batch = _default_batch_keys(batch)
        b = _local_rows(batch, ("s0", "i0", "r0", "beta", "gamma"), mesh, axis, device)
        gi = b["graph_idx"]
        with torch.inference_mode():
            mask = None if node_mask_fn is None else node_mask_fn(gi, *extra)
            pred = model.predict(params, adj_fn(gi, *extra), b["s0"], b["i0"], b["r0"],
                                 b["beta"], b["gamma"])
            if mask is not None:
                pred = pred * mask[None, :, :, None]
            if reduce_fn is not None:
                pred = reduce_fn(pred, mask) if mask is not None else reduce_fn(pred)
            pred = pred.contiguous()
            parts = [torch.empty_like(pred) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, pred, group=group)
            return torch.cat(parts, dim=0 if reduce_fn is not None else 1)

    return predict
