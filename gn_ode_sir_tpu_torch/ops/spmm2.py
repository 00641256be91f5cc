"""K1: the sorted-COO SpMM of the GN-ODE vector field, as a CUDA kernel.

    out[..., d, :] = sum_{e : dst[e] == d} w[e] * x[..., src[e], :]

Replaces the chunked Pallas TPU kernel
``gn_ode_sir_tpu/ops/pallas_spmm2.py::_kernel`` (and its ``Pallas2Adj``
adjacency, selected by ``--spmm pallas2|pallas2-bf16``). The kernel is
``gn_ode_sir_tpu_torch/csrc/spmm2.cu``; its host plan is :class:`CsrPlan`.

What bounds it on an H100 SXM, one f32 [n, 64] apply at enron size
(n = 33,696, E = 361k directed edges, largest row 1,436 edges): counting
each input and output once it moves ~20 MB (x and out 8.6 MB each, src and
w 1.45 MB each), ~6 us at 3.35 TB/s, against ~0.7 us for its 46 MFLOP at
67 TFLOP/s — memory-bound. A gather kernel really reads E·h·4 = 92 MB of x
rows per scenario, though, one row per edge; one scenario's x fits the
50 MB L2, so that is L2 traffic and the time follows the number of row
loads in flight.

What the design does about it: the plan is a work list of segments of at
most ``SEGMENT_EDGES`` consecutive edges of one dst row. A row that fits is
one item, whose lanes write the output row; a longer (hub) row is cut into
several items that write partial sums to scratch slots, and a small second
kernel of the same apply adds each long row's slots in segment order. The
list is sorted by edge count, largest first, so the pieces of hubs lead and
the items that share a warp or a block are equally long. Where a row of x
is a multiple of 16 bytes, 16 lanes (f32, h = 64) or 8 (bf16) take one item
with 16-byte loads, so one load instruction of a warp gathers a row for
each of its two or four items, two such instructions in flight, for two
scenarios at once, so that src and w are read once per pair; registers are
capped so that 32 warps stay resident on an SM. Rows of x shorter than 128
bytes (f32 h <= 31, bf16 h <= 63: the multi-graph runs at hidden 8, GIN's
first layer at 5) take a narrow route of the same kernel source: a lane per
(item, scenario, column vector), the lanes of an item spanning several
scenarios, and a fixup with a lane per (scenario, long row, column vector)
that is launched beside the segment kernel and waits for it. A lane adds
its item's messages in edge order. Every output element is written by one
thread in an order the plan fixes: no atomics, two applies give the same
bits, either route gives the same bits, and an edgeless row (an item of no
edges) writes zeros.

Beside the kernel: :func:`spmm2_plain`, the same function as a gather and an
``index_add_`` with the same bf16 rounding. :func:`spmm2` takes the plain
version only for a CPU tensor; a CUDA tensor launches the kernel or raises.
``spmm2.launches`` counts applies that launched the kernel, forward and
backward.

The gradient (K1-bwd, ``gn_ode_sir_tpu/ops/pallas_spmm2.py::_spmm2_diff_bwd``)
is the same kernel on the transpose plan: ``dx[s] = sum_{src[e]=s} w[e] *
g[dst[e]]``, with the cotangent and the weights rounded to bf16 in bf16
mode, as the reference's ``custom_vjp`` rounds them. :class:`Spmm2Adj`
builds the transpose plan once on the host and routes ``matvec`` through one
``torch.autograd.Function`` on both devices, so that the CPU path has that
gradient too (plain autograd through :func:`spmm2_plain` would differentiate
the bf16 casts instead). ``spmm2.backward_launches`` counts, beside the
launch, those that a backward pass made.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gn_ode_sir_tpu_torch.ops import _kernels
from gn_ode_sir_tpu_torch.ops.segment import segment_sum

PRECISIONS = ("f32", "bf16")
SEGMENT_EDGES = 64  # the most edges of one work item


def _work_list(counts: np.ndarray, row_ptr: np.ndarray, segment_edges: int):
    """Cut the rows of a CSR into work items of at most ``segment_edges``
    consecutive edges. Every row has at least one item, so that an edgeless
    row is written too. Returns ``(work, fix_row, fix_ptr, edge_item,
    item_row)``:

    - ``work`` int32 [W, 4] of (first edge, edge count, dst row, slot), sorted
      by edge count, largest first (so the pieces of long rows lead, the
      items of one warp and block are equally long and the last blocks are
      the shortest), items of equal count in row order. slot is -1 for a
      whole row, else the index of the item's partial sum, the slots of one
      row consecutive and in edge order;
    - ``fix_row`` [F] the rows cut into several items (long rows) and
      ``fix_ptr`` [F + 1] the range of slots of each;
    - for the plain version, items numbered in (row, edge) order:
      ``edge_item`` [E] the item of each edge, ``item_row`` [W] the row of
      each item."""
    n = counts.size
    pieces = np.maximum(1, -(-counts // segment_edges))
    row = np.repeat(np.arange(n, dtype=np.int64), pieces)
    k = np.arange(row.size, dtype=np.int64) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    first = row_ptr[row] + k * segment_edges
    count = np.minimum(segment_edges, counts[row] - k * segment_edges)
    cut = pieces[row] > 1
    slot = np.where(cut, np.cumsum(cut) - 1, -1)
    order = np.argsort(-count, kind="stable")
    work = np.stack([first, count, row, slot], axis=1)[order]
    fix_row = np.flatnonzero(pieces > 1)
    fix_ptr = np.concatenate([[0], np.cumsum(pieces[fix_row])])
    edge_item = np.repeat(np.arange(row.size, dtype=np.int64), count)
    return work, fix_row, fix_ptr, edge_item, row


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """A dst-sorted edge list on one device, with its CSR row pointer and the
    kernel's work list (see :func:`_work_list`)."""

    row_ptr: torch.Tensor  # int32 [n + 1]
    src: torch.Tensor  # int32 [E]
    dst: torch.Tensor  # int32 [E]
    w: torch.Tensor  # float32 [E]
    edge_item: torch.Tensor  # int32 [E]: the plain version's ids, edge -> item
    item_row: torch.Tensor  # int32 [W]: and item -> dst row, in (row, edge) order
    work: torch.Tensor  # int32 [W, 4]: first edge, edge count, dst row, slot
    fix_row: torch.Tensor  # int32 [F]: the rows cut into several items
    fix_ptr: torch.Tensor  # int32 [F + 1]: their ranges of partial-sum slots
    n_nodes: int

    def __post_init__(self):
        tensors = (self.row_ptr, self.src, self.dst, self.w, self.edge_item, self.item_row,
                   self.work, self.fix_row, self.fix_ptr)
        if len({t.device for t in tensors}) != 1:
            raise ValueError("the tensors of a plan must lie on one device")
        # what every launch hands the kernel, read off the tensors once
        object.__setattr__(self, "_kernel_args", (
            self.work.data_ptr(), self.work.shape[0], self.src.data_ptr(), self.w.data_ptr(),
            self.fix_row.data_ptr(), self.fix_ptr.data_ptr(), self.fix_row.shape[0]))

    @property
    def n_slots(self) -> int:
        """Partial sums one scenario's apply writes to scratch."""
        return self.work.shape[0] - self.n_nodes + self.fix_row.shape[0]

    @staticmethod
    def build(src, dst, n_nodes: int, w=None, *, device) -> "CsrPlan":
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("src/dst must be 1-D arrays of equal length")
        if src.size:
            if np.any(np.diff(dst) < 0):
                raise ValueError("edge list must be dst-sorted")
            lo, hi = min(src.min(), dst.min()), max(src.max(), dst.max())
            if lo < 0 or hi >= n_nodes:
                raise ValueError(f"edge endpoint outside [0, {n_nodes})")
        if src.size >= 2**31:
            raise ValueError("more than 2^31 - 1 edges: int32 row_ptr overflows")
        w = np.ones(src.shape, np.float32) if w is None else np.asarray(w, np.float32)
        counts = np.bincount(dst, minlength=n_nodes)
        row_ptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        work, fix_row, fix_ptr, edge_item, item_row = _work_list(
            counts, row_ptr, SEGMENT_EDGES)
        as_t = lambda a, dt: torch.as_tensor(a.astype(dt), device=device)
        return CsrPlan(row_ptr=as_t(row_ptr, np.int32), src=as_t(src, np.int32),
                       dst=as_t(dst, np.int32), w=as_t(w, np.float32),
                       edge_item=as_t(edge_item, np.int32),
                       item_row=as_t(item_row, np.int32), work=as_t(work, np.int32),
                       fix_row=as_t(fix_row, np.int32), fix_ptr=as_t(fix_ptr, np.int32),
                       n_nodes=int(n_nodes))


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def spmm2_plain(plan: CsrPlan, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """The plain PyTorch version of K1: gather, scale, ``index_add_``.

    ``x``: [n, h] or [B, n, h], float32 or bfloat16. Returns float32 of the
    same shape. ``precision='bf16'`` rounds each message to
    bf16(bf16(x) * bf16(w)) before the f32 sum, as the JAX kernel does.

    The sum is taken as the kernel takes it, edges into work items and items
    into rows, and so (on the CPU, where ``index_add_`` adds in index order)
    in the kernel's order: a row cut into several items is the sum of their
    partial sums. One flat sum over a 1,436-edge hub row rounds differently
    enough from that to move a gradient leaf of one training step by 1.6e-4
    of its size, which the card-against-CPU check would read as a fault."""
    _check_precision(precision)
    if precision == "bf16":
        msgs = (x.to(torch.bfloat16)[..., plan.src, :]
                * plan.w.to(torch.bfloat16)[:, None]).float()
    else:
        msgs = x.float()[..., plan.src, :] * plan.w[:, None]
    dim = msgs.dim() - 2
    items = segment_sum(msgs, plan.edge_item, plan.item_row.shape[0], dim=dim)
    return segment_sum(items, plan.item_row, plan.n_nodes, dim=dim)


def _launch(plan: CsrPlan, x: torch.Tensor, precision: str, backward: bool) -> torch.Tensor:
    _kernels.check("spmm2", x.device, [((torch.float32, torch.bfloat16), (x,))], (x,))
    if x.dim() not in (2, 3) or x.shape[-2] != plan.n_nodes:
        raise ValueError(
            f"x must be [n, h] or [B, n, h] with n = {plan.n_nodes}, got {tuple(x.shape)}")
    if plan.work.device != x.device:
        raise ValueError(f"plan lies on {plan.work.device}, x on {x.device}")
    b = x.shape[0] if x.dim() == 3 else 1
    n, h = x.shape[-2:]
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel():
        n_slots = plan.n_slots
        # scratch for the partial sums of the rows cut into several items;
        # it may go back to the allocator at once: this stream is its only user
        partial = (torch.empty((b, n_slots, h), dtype=torch.float32, device=x.device)
                   if n_slots else None)
        _kernels.launch("spmm2", x.device, x.data_ptr(), x.dtype == torch.bfloat16,
                        precision == "bf16", *plan._kernel_args,
                        partial.data_ptr() if n_slots else None, n_slots, out.data_ptr(),
                        n, h, b)
        spmm2.launches += 1
        spmm2.backward_launches += int(backward)
    return out


def _apply(plan: CsrPlan, x: torch.Tensor, precision: str, backward: bool) -> torch.Tensor:
    _check_precision(precision)
    if _kernels.on_cuda("spmm2", x.device):
        return _launch(plan, x, precision, backward)
    return spmm2_plain(plan, x, precision)


def spmm2(plan: CsrPlan, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """K1: ``out[..., d, :] = sum_{dst[e]=d} w[e] * x[..., src[e], :]``.

    A CUDA ``x`` launches the kernel (or raises); a CPU ``x`` takes
    :func:`spmm2_plain`. Returns float32 [n, h] or [B, n, h]."""
    return _apply(plan, x, precision, backward=False)


spmm2.launches = 0  # kernel launches since the last reset (CPU calls do not count)
spmm2.backward_launches = 0  # those of them made by backward passes


class _Spmm2Function(torch.autograd.Function):
    """``spmm2`` with K1-bwd as its gradient; none flows to the plans.

    Under ``torch.func.vmap`` over a member axis (the ensemble's K members
    sharing one adjacency, ``train/ensemble.py``) the ``vmap`` rule folds the
    members into the scenario axis: x [K, B, n, h] becomes one launch at
    [K·B, n, h], and its gradient one K1-bwd launch at the same shape. Each
    scenario's sum keeps its order, so the fold gives the bits of K
    separate launches."""

    @staticmethod
    def forward(x, plan, plan_t, precision):
        return spmm2(plan, x, precision)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, _, plan_t, precision = inputs
        ctx.plan_t, ctx.precision, ctx.x_dtype = plan_t, precision, x.dtype

    @staticmethod
    def backward(ctx, g):
        dx = _apply(ctx.plan_t, g.contiguous(), ctx.precision, backward=True)
        return dx.to(ctx.x_dtype), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, plan, plan_t, precision):
        if in_dims[0] is None:
            return _Spmm2Function.apply(x, plan, plan_t, precision), None
        x = x.movedim(in_dims[0], 0)
        folded = x.reshape(-1, *x.shape[-2:]).contiguous()
        out = _Spmm2Function.apply(folded, plan, plan_t, precision)
        return out.reshape(x.shape), 0


@dataclasses.dataclass(frozen=True)
class Spmm2Adj:
    """Adjacency backed by K1, the port of ``Pallas2Adj``: ``matvec`` on
    x [B, n, h] returns the float32 A·x and is differentiable in x.
    ``plan_t`` is the transpose plan (edges sorted by src, roles swapped)."""

    plan: CsrPlan
    plan_t: CsrPlan
    precision: str = "f32"

    @staticmethod
    def from_edges(src, dst, n_nodes: int, w=None, *, precision: str = "f32",
                   device) -> "Spmm2Adj":
        """From a dst-sorted edge list over ``n_nodes`` rows. ``n_nodes`` may
        exceed the largest endpoint (a graph padded to a batch's width): the
        rows beyond it are edgeless and come out as zeros."""
        _check_precision(precision)
        src, dst = np.asarray(src), np.asarray(dst)
        w = np.ones(src.shape, np.float32) if w is None else np.asarray(w, np.float32)
        order = np.argsort(src, kind="stable")
        return Spmm2Adj(
            CsrPlan.build(src, dst, n_nodes, w=w, device=device),
            CsrPlan.build(dst[order], src[order], n_nodes, w=w[order], device=device),
            precision)

    @staticmethod
    def from_graph(graph, w=None, *, precision: str = "f32", device) -> "Spmm2Adj":
        return Spmm2Adj.from_edges(graph.src, graph.dst, graph.n_nodes, w,
                                   precision=precision, device=device)

    @property
    def n_nodes(self) -> int:
        return self.plan.n_nodes

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _Spmm2Function.apply(x, self.plan, self.plan_t, self.precision)
