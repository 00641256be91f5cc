"""Segment reductions over edge lists (port of ``gn_ode_sir_tpu.ops.segment``)."""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                dim: int = 0) -> torch.Tensor:
    """Sum slices of ``data`` along ``dim`` into ``num_segments`` buckets keyed
    by ``segment_ids`` (one ``index_add``; ids need not be sorted). Out of
    place, so that it runs under ``torch.func.vmap`` (the ensemble's
    evaluation folds its members into one call)."""
    shape = list(data.shape)
    shape[dim] = num_segments
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    return out.index_add(dim, segment_ids, data)


def segment_prod(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 dim: int = 0) -> torch.Tensor:
    """Product-reduce slices of ``data`` along ``dim`` into ``num_segments``
    buckets (DMP's node product). An empty segment gives 1, the
    multiplicative identity. ``segment_prod.calls`` counts the calls since
    import."""
    segment_prod.calls += 1
    shape = list(data.shape)
    shape[dim] = num_segments
    out = torch.ones(shape, dtype=data.dtype, device=data.device)
    view = [1] * data.dim()
    view[dim] = -1
    index = segment_ids.long().view(view).expand_as(data)
    return out.scatter_reduce_(dim, index, data, "prod", include_self=True)


segment_prod.calls = 0
