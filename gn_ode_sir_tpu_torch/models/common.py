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


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


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
