"""Tracing, structured metrics and device memory (port of
``gn_ode_sir_tpu.utils.profiling``).

- :func:`trace` — a context manager over ``torch.profiler.profile`` (CPU and,
  where a card is visible, CUDA activities) that writes a Chrome/TensorBoard
  trace into ``log_dir``;
- :class:`MetricsLogger` — append-only JSONL of per-epoch/step metrics, the
  same lines as the JAX package's;
- :func:`device_memory_stats` — the allocator's statistics of one card.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/trace'): step(...)``, then open the
    ``*.pt.trace.json`` file it leaves in ``log_dir`` in TensorBoard's profiler
    plugin, Perfetto or ``chrome://tracing``. Synchronizes nothing itself:
    wrap whole regions that end in ``torch.cuda.synchronize()`` for
    meaningful spans."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


class MetricsLogger:
    """Append-only JSONL metrics sink with wall-clock stamps."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._t0 = time.time()

    def log(self, **fields) -> None:
        fields.setdefault("wall_s", round(time.time() - self._t0, 4))
        with open(self.path, "a") as f:
            f.write(json.dumps(fields, default=float) + "\n")

    def read(self) -> list:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def device_memory_stats(device=None) -> dict:
    """``torch.cuda.memory_stats`` of one card (default: the current one);
    an empty dict for a CPU device or where no card is visible."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
