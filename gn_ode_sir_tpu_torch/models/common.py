"""Shared parameter helpers (port of ``gn_ode_sir_tpu.models.common``).

Linear layers follow torch ``nn.Linear`` reset semantics:
W, b ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)), with W stored [fan_in, fan_out]
as on the JAX side, so one params dict layout serves both packages.
"""

from __future__ import annotations

import math

import torch


def linear_init(generator: torch.Generator, fan_in: int, fan_out: int, *,
                device) -> dict:
    """Draw {"w": [fan_in, fan_out], "b": [fan_out]} from ``generator`` (a CPU
    generator, so a seed gives the same params on every device)."""
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty((fan_in, fan_out)).uniform_(-bound, bound, generator=generator)
    b = torch.empty((fan_out,)).uniform_(-bound, bound, generator=generator)
    return {"w": w.to(device), "b": b.to(device)}


class _Linear(torch.autograd.Function):
    """``x @ w + b`` with its gradient written out (the products autograd
    takes for it), and a ``vmap`` rule that runs a member axis one member
    after another. Under ``torch.func.vmap`` over the ensemble's members
    (``train/ensemble.py``) member j's products and their reductions are
    then those of a run of member j alone, bit for bit: a batched matmul
    sums in another order, on a card by 1e-4 of a gradient leaf, and Adam
    carries that into 1e-3 of the loss within three steps."""

    @staticmethod
    def forward(x, w, b):
        return x @ w + b

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        flat = g.reshape(-1, g.shape[-1])
        gx = (flat @ w.t()).reshape(x.shape) if ctx.needs_input_grad[0] else None
        gw = x.reshape(-1, x.shape[-1]).t() @ flat if ctx.needs_input_grad[1] else None
        gb = flat.sum(0) if ctx.needs_input_grad[2] else None
        return gx, gw, gb

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        member = lambda t, d, j: t if d is None else t.select(d, j)
        return torch.stack([
            _Linear.apply(*(member(t, d, j) for t, d in zip((x, w, b), in_dims)))
            for j in range(info.batch_size)]), 0


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` over the last axis of ``x``."""
    return _Linear.apply(x, p["w"], p["b"])


def layer_norm(scale, bias, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def dropout(generator: torch.Generator | None, x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout (torch ``F.dropout`` semantics): identity unless
    training with a positive rate and a generator. The mask is drawn from
    ``generator`` (on its device) and moved to ``x``'s. Shared by GCN/GIN."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, 0.0)
