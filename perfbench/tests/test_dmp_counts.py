"""``counts/dmp.py`` against an op-by-op count of the reference: every
tensor each of the reference's steps takes and gives, in float32, on a
small power-law graph."""

import pytest
import torch

from perfbench import inputs
from perfbench.counts import dmp as counts
from perfbench.reference import dmp as ref


def test_least_bytes_are_what_the_reference_steps_read_and_write(monkeypatch):
    n, b, max_time = 40, 3, 7
    src, dst = (torch.as_tensor(a) for a in inputs.directed(inputs.powerlaw_pairs(n, 200, 2)))
    moved = []
    step = ref.step

    def counted(*args, **kwargs):
        out = step(*args, **kwargs)
        tensors = [x for x in (*args, *out) if isinstance(x, torch.Tensor) and x.dim()]
        assert all(x.dtype == torch.float32 for x in tensors)
        moved.append(sum(x.nbytes for x in tensors))
        return out

    monkeypatch.setattr(ref, "step", counted)
    seeds = torch.zeros(b, n)
    seeds[:, :2] = 1
    ref.predict(src, dst, n, seeds, torch.full((b,), 0.3), torch.full((b,), 0.2),
                max_time=max_time, dtype=torch.float32)
    assert len(moved) == max_time - 1
    E = len(src)
    assert sum(moved) == counts.least_bytes(n, E, b, max_time - 1)
    assert moved[0] == 4 * counts.step_elements(n, E, b, first=True)
    per = counts.bytes_per_edge_update(n, E, max_time - 1)
    assert per * b * E * (max_time - 1) == sum(moved)


def test_enron_bytes_an_edge_update():
    per = counts.bytes_per_edge_update(33_696, 361_622, 19)
    assert round(per, 1) == 26.0
    assert counts.bound_s(128 * 361_622 * 19, 33_696, 361_622, 19) == pytest.approx(
        counts.least_bytes(33_696, 361_622, 128, 19) / 3.35e12, rel=1e-12)
