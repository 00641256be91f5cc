"""Wall-clock timing helpers with device synchronization (port of
``gn_ode_sir_tpu.utils.timing``).

PyTorch returns from a CUDA call before the card has done the work, so a
bare host clock measures the enqueue. Where the JAX package calls
``jax.block_until_ready`` on the output, these helpers call
``torch.cuda.synchronize`` on each CUDA device the output lies on.
"""

from __future__ import annotations

import time

import torch


def _cuda_devices(tree) -> set:
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*map(_cuda_devices, tree))
    return set()


def block_until_ready(tree):
    """Wait for the card to finish the work behind every CUDA tensor in
    ``tree`` (a tensor, or dicts, lists and tuples of them); CPU tensors and
    other values need no wait. Returns ``tree``."""
    for device in _cuda_devices(tree):
        torch.cuda.synchronize(device)
    return tree


class Timer:
    """``with Timer() as t: ...; t.seconds`` — synchronizes on ``block_on``."""

    def __init__(self, block_on=None):
        self._block_on = block_on
        self.seconds = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._block_on is not None:
            block_until_ready(self._block_on)
        self.seconds = time.perf_counter() - self._start
        return False

    def block_on(self, x):
        """Record what to synchronize on before stopping the clock."""
        self._block_on = x
        return x


def timed(fn, *args, **kwargs):
    """Run fn, synchronize on its output, return (result, seconds)."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    block_until_ready(out)
    return out, time.perf_counter() - start
