"""K1: the sorted-COO SpMM of the GN-ODE vector field, as a CUDA kernel.

    out[..., d, :] = sum_{e : dst[e] == d} w[e] * x[..., src[e], :]

Replaces the chunked Pallas TPU kernel
``gn_ode_sir_tpu/ops/pallas_spmm2.py::_kernel`` (and its ``Pallas2Adj``
adjacency, selected by ``--spmm pallas2|pallas2-bf16``). The kernel,
``gn_ode_sir_tpu_torch/csrc/spmm2.cu``, walks a CSR over dst with one warp
per (scenario, dst row): the gather of ``x[src] * w`` is fused into the
reduction, each output row is written once (no atomics, deterministic), and
an edgeless row writes zeros.

Bound on an H100 SXM, one f32 [n, 64] apply at enron size (n = 33,696,
E = 361k directed edges): ~20 MB moved (x and out 8.6 MB each, src and w
1.45 MB each, row_ptr 0.13 MB), ~6 us at 3.35 TB/s, against ~0.7 us for its
46 MFLOP at 67 TFLOP/s — memory-bound.

Beside the kernel: :func:`spmm2_plain`, the same function as a gather and an
``index_add_`` with the same bf16 rounding. :func:`spmm2` takes the plain
version only for a CPU tensor; a CUDA tensor launches the kernel or raises.
``spmm2.launches`` counts kernel launches, forward and backward.

The gradient (K1-bwd, ``gn_ode_sir_tpu/ops/pallas_spmm2.py::_spmm2_diff_bwd``)
is the same kernel on the transpose CSR: ``dx[s] = sum_{src[e]=s} w[e] *
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


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """A dst-sorted edge list with its CSR row pointer, on one device."""

    row_ptr: torch.Tensor  # int32 [n + 1]
    src: torch.Tensor  # int32 [E]
    dst: torch.Tensor  # int32 [E] (the plain version's index_add_ ids)
    w: torch.Tensor  # float32 [E]
    n_nodes: int

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
        row_ptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=n_nodes), out=row_ptr[1:])
        as_t = lambda a, dt: torch.as_tensor(a.astype(dt), device=device)
        return CsrPlan(row_ptr=as_t(row_ptr, np.int32), src=as_t(src, np.int32),
                       dst=as_t(dst, np.int32), w=as_t(w, np.float32),
                       n_nodes=int(n_nodes))


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def spmm2_plain(plan: CsrPlan, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """The plain PyTorch version of K1: gather, scale, ``index_add_``.

    ``x``: [n, h] or [B, n, h], float32 or bfloat16. Returns float32 of the
    same shape. ``precision='bf16'`` rounds each message to
    bf16(bf16(x) * bf16(w)) before the f32 sum, as the JAX kernel does."""
    _check_precision(precision)
    if precision == "bf16":
        msgs = (x.to(torch.bfloat16)[..., plan.src, :]
                * plan.w.to(torch.bfloat16)[:, None]).float()
    else:
        msgs = x.float()[..., plan.src, :] * plan.w[:, None]
    return segment_sum(msgs, plan.dst, plan.n_nodes, dim=msgs.dim() - 2)


def _launch(plan: CsrPlan, x: torch.Tensor, precision: str, backward: bool) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spmm2 kernel takes float32 or bfloat16 x, got {x.dtype}")
    if x.dim() not in (2, 3) or x.shape[-2] != plan.n_nodes:
        raise ValueError(
            f"x must be [n, h] or [B, n, h] with n = {plan.n_nodes}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("spmm2 kernel takes a contiguous x")
    for t in (plan.row_ptr, plan.src, plan.w):
        if t.device != x.device:
            raise ValueError(f"plan lies on {t.device}, x on {x.device}")
    xb = x if x.dim() == 3 else x[None]
    b, n, h = xb.shape
    out = torch.empty((b, n, h), dtype=torch.float32, device=x.device)
    if out.numel():
        fn = _kernels.kernel_function("spmm2")
        with torch.cuda.device(x.device):
            err = fn(xb.data_ptr(), int(x.dtype == torch.bfloat16),
                     int(precision == "bf16"), plan.row_ptr.data_ptr(),
                     plan.src.data_ptr(), plan.w.data_ptr(), out.data_ptr(),
                     n, h, b, torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"spmm2 kernel launch failed: cudaError_t {err}")
        spmm2.launches += 1
        spmm2.backward_launches += int(backward)
    return out if x.dim() == 3 else out[0]


def _apply(plan: CsrPlan, x: torch.Tensor, precision: str, backward: bool) -> torch.Tensor:
    _check_precision(precision)
    if x.device.type == "cuda":
        return _launch(plan, x, precision, backward)
    if x.device.type == "cpu":
        return spmm2_plain(plan, x, precision)
    raise ValueError(f"spmm2 runs on cuda or cpu tensors, got {x.device}")


def spmm2(plan: CsrPlan, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """K1: ``out[..., d, :] = sum_{dst[e]=d} w[e] * x[..., src[e], :]``.

    A CUDA ``x`` launches the kernel (or raises); a CPU ``x`` takes
    :func:`spmm2_plain`. Returns float32 [n, h] or [B, n, h]."""
    return _apply(plan, x, precision, backward=False)


spmm2.launches = 0  # kernel launches since the last reset (CPU calls do not count)
spmm2.backward_launches = 0  # those of them made by backward passes


class _Spmm2Function(torch.autograd.Function):
    """``spmm2`` with K1-bwd as its gradient; none flows to the plans."""

    @staticmethod
    def forward(ctx, x, plan, plan_t, precision):
        ctx.plan_t, ctx.precision, ctx.x_dtype = plan_t, precision, x.dtype
        return spmm2(plan, x, precision)

    @staticmethod
    def backward(ctx, g):
        dx = _apply(ctx.plan_t, g.contiguous(), ctx.precision, backward=True)
        return dx.to(ctx.x_dtype), None, None, None


@dataclasses.dataclass(frozen=True)
class Spmm2Adj:
    """Adjacency backed by K1, the port of ``Pallas2Adj``: ``matvec`` on
    x [B, n, h] returns the float32 A·x and is differentiable in x.
    ``plan_t`` is the transpose plan (edges sorted by src, roles swapped)."""

    plan: CsrPlan
    plan_t: CsrPlan
    precision: str = "f32"

    @staticmethod
    def from_graph(graph, w=None, *, precision: str = "f32", device) -> "Spmm2Adj":
        _check_precision(precision)
        src, dst = np.asarray(graph.src), np.asarray(graph.dst)
        w = np.ones(src.shape, np.float32) if w is None else np.asarray(w, np.float32)
        order = np.argsort(src, kind="stable")
        return Spmm2Adj(
            CsrPlan.build(src, dst, graph.n_nodes, w=w, device=device),
            CsrPlan.build(dst[order], src[order], graph.n_nodes, w=w[order], device=device),
            precision)

    @property
    def n_nodes(self) -> int:
        return self.plan.n_nodes

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return _Spmm2Function.apply(x, self.plan, self.plan_t, self.precision)
