"""Tracing, structured metrics and device memory (port of
``gn_ode_sir_tpu.utils.profiling``).

- :func:`trace` — a context manager over ``torch.profiler.profile`` (CPU and,
  where a card is visible, CUDA activities) that writes a Chrome/TensorBoard
  trace into ``log_dir``;
- :func:`span` — a phase of the program (``train.forward``, ``serve.upload``,
  ``labels.steps``, ...) marked in whatever trace a profiler is recording,
  and nothing at all while none is;
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
from torch.autograd import _profiler_enabled

_OFF = contextlib.nullcontext()  # what span returns while no profiler records


def span(name: str):
    """``with span("train.forward"): ...`` marks a phase of the program.

    While a ``torch.profiler`` profile records (:func:`trace`, or any other),
    it is a ``torch.profiler.record_function`` range: a host event on the
    profiler's clock, in the same event list and trace file as the kernels.
    Otherwise it returns one shared no-op context: no ``record_function``
    (about 10 us a range even with no profiler), no allocation, no device
    sync; the check is one global read. Spans are meant side by side at a
    layer's boundaries, not one inside another, so that each is a top-level
    host event of its thread."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


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
