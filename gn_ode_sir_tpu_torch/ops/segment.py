"""Segment reductions over edge lists (port of ``gn_ode_sir_tpu.ops.segment``)."""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                dim: int = 0) -> torch.Tensor:
    """Sum slices of ``data`` along ``dim`` into ``num_segments`` buckets keyed
    by ``segment_ids`` (one ``index_add_``; ids need not be sorted)."""
    shape = list(data.shape)
    shape[dim] = num_segments
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    return out.index_add_(dim, segment_ids, data)
