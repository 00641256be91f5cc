"""``fused_step_share.serve``: K3's launches over K1's, None off the card,
before K1 has launched, or without the program's counter."""

import builtins
from types import SimpleNamespace

import pytest

from perfbench import harness


def _read(on_card=True):
    return harness.load_module("metrics", "fused_step_share.serve").read(
        SimpleNamespace(on_card=on_card))


def test_share_of_k1_applies(monkeypatch):
    from gn_ode_sir_tpu_torch.ops.gnode_step import gnode_step
    from gn_ode_sir_tpu_torch.ops.spmm2 import spmm2

    monkeypatch.setattr(spmm2, "launches", 39 * 7)
    monkeypatch.setattr(gnode_step, "launches", 39 * 7)
    assert _read() == pytest.approx(100.0)
    assert _read(on_card=False) is None
    monkeypatch.setattr(gnode_step, "launches", 39 * 7 - 39)
    assert _read() == pytest.approx(600 / 7)
    monkeypatch.setattr(spmm2, "launches", 0)
    assert _read() is None
    monkeypatch.setattr(spmm2, "launches", 39)
    monkeypatch.delattr(gnode_step, "launches")  # a kernel without the counter
    assert _read() is None


def test_none_without_the_kernel(monkeypatch):
    """A program without ``ops.gnode_step`` (the parent of the change that
    added K3)."""
    from gn_ode_sir_tpu_torch.ops.spmm2 import spmm2

    real_import = builtins.__import__

    def without_k3(name, *args, **kwargs):
        if name == "gn_ode_sir_tpu_torch.ops.gnode_step":
            raise ModuleNotFoundError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(spmm2, "launches", 39)
    monkeypatch.setattr(builtins, "__import__", without_k3)
    assert _read() is None
