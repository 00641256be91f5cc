"""``fused_dmp_step_share.serve``: K4's launches over the node products,
None off the card, before a node product, or without the program's
counter."""

import builtins
from types import SimpleNamespace

import pytest

from perfbench import harness


def _read(on_card=True):
    return harness.load_module("metrics", "fused_dmp_step_share.serve").read(
        SimpleNamespace(on_card=on_card))


def test_share_of_node_products(monkeypatch):
    from gn_ode_sir_tpu_torch.ops.dmp_step import dmp_step
    from gn_ode_sir_tpu_torch.ops.segment import segment_prod

    monkeypatch.setattr(segment_prod, "calls", 19 * 5)
    monkeypatch.setattr(dmp_step, "launches", 19 * 5)
    assert _read() == pytest.approx(100.0)
    assert _read(on_card=False) is None
    monkeypatch.setattr(dmp_step, "launches", 19 * 4)
    assert _read() == pytest.approx(80.0)
    monkeypatch.setattr(segment_prod, "calls", 0)
    assert _read() is None
    monkeypatch.setattr(segment_prod, "calls", 19)
    monkeypatch.delattr(dmp_step, "launches")  # a kernel without the counter
    assert _read() is None


def test_none_without_the_kernel(monkeypatch):
    """A program without ``ops.dmp_step`` (the parent of the change that
    added K4)."""
    from gn_ode_sir_tpu_torch.ops.segment import segment_prod

    real_import = builtins.__import__

    def without_k4(name, *args, **kwargs):
        if name == "gn_ode_sir_tpu_torch.ops.dmp_step":
            raise ModuleNotFoundError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(segment_prod, "calls", 19)
    monkeypatch.setattr(builtins, "__import__", without_k4)
    assert _read() is None
