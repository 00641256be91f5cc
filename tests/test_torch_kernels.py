"""The launch path of every hand-written kernel (K1-K5), driven on CPU tensors.

A wrapper's kernel path (what a CUDA tensor takes) is run here on CPU
tensors, which the shared check of ``ops/_kernels.py`` treats as it treats
CUDA ones: a wrong dtype, a non-contiguous tensor and a tensor on another
device are refused, and a kernel that cannot be built raises, naming it,
with no fallback to the plain version and no launch counted. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from gn_ode_sir_tpu_torch.ops import _kernels
from gn_ode_sir_tpu_torch.ops import dmp_step as k45
from gn_ode_sir_tpu_torch.ops import gnode_step as k3
from gn_ode_sir_tpu_torch.ops import spmm2 as k1
from gn_ode_sir_tpu_torch.sim import fused_step as k2

torch.set_num_threads(1)


def _k1():
    n = 6
    src, dst = np.array([1, 2, 0, 3, 5, 4]), np.array([0, 0, 1, 2, 2, 5])
    x = torch.rand(2, n, 8)
    return (k1._launch, dict(plan=k1.CsrPlan.build(src, dst, n, device="cpu"), x=x,
                             precision="f32", backward=False),
            lambda: (k1.spmm2.launches, k1.spmm2.backward_launches),
            {"dtype": ("x", x.double()), "strided": ("x", torch.rand(n, 2, 8).transpose(0, 1)),
             "foreign": ("x", x.to("meta"), "plan lies")})


def _k2():
    rows, n = 4, 5
    i = torch.zeros(rows, n, dtype=torch.int8)
    return (k2._launch, dict(i=i, r=i.clone(), counts=torch.zeros(rows, n),
                             log1m_beta=torch.zeros(2), gamma16=torch.zeros(2),
                             seeds=torch.zeros(2, dtype=torch.int64), step=3, sims=2,
                             return_words=False),
            lambda: k2.sir_step.launches,
            {"dtype": ("counts", torch.zeros(rows, n, dtype=torch.float64)),
             "strided": ("i", torch.zeros(n, rows, dtype=torch.int8).t()),
             "foreign": ("seeds", torch.zeros(2, dtype=torch.int64, device="meta"), "tensors on")})


def _k3():
    b, n, h = 2, 5, 4
    z = lambda *s: torch.zeros(s)
    return (k3._launch, dict(ai=z(b, n, h), zs=z(b, n, h), zi=z(b, n, h), state=z(3, b, n, h),
                             beta=z(b), gamma=z(b), dt=0.5, out=z(b, n, 3, h)),
            lambda: k3.gnode_step.launches,
            {"dtype": ("beta", torch.zeros(b, dtype=torch.float64)),
             "strided": ("ai", z(b, h, n).transpose(1, 2)),
             "foreign": ("gamma", torch.zeros(b, device="meta"), "tensors on")})


def _k4():
    b, e, n = 2, 7, 4
    z = lambda *s: torch.zeros(s)
    return (k45._launch_step,
            dict(theta=z(e, b), theta_next=z(e, b), phi=z(e, b), ps_ij=z(e, b), pair=z(n, b, 2),
                 w=z(1, b), gamma=z(n, b), src=torch.zeros(e, dtype=torch.int32),
                 reverse=torch.zeros(e, dtype=torch.int32)),
            lambda: k45.dmp_step.launches,
            {"dtype": ("phi", torch.zeros(e, b, dtype=torch.float64)),
             "strided": ("theta", z(b, e).t()),
             "foreign": ("w", torch.zeros(1, b, device="meta"), "tensors on")})


def _k5():
    b, n = 2, 4
    z = lambda *s: torch.zeros(s)
    return (k45._launch_marginals, dict(out=z(b, n, 3), prev=z(b, n, 3), node=z(n, b),
                                        ps_0=z(n, b), gamma=z(1, b), pair=z(n, b, 2)),
            lambda: k45.dmp_marginals.launches,
            {"dtype": ("pair", torch.zeros(n, b, 2, dtype=torch.float64)),
             "strided": ("pair", z(n, 2, b).transpose(1, 2)),
             "foreign": ("gamma", torch.zeros(1, b, device="meta"), "tensors on")})


@pytest.mark.parametrize("kernel,case", [
    ("spmm2", _k1), ("sir_step", _k2), ("gnode_step", _k3), ("dmp_edge_step", _k4),
    ("dmp_marginals", _k5)])
def test_kernel_path_refuses_what_the_kernel_cannot_take(kernel, case, monkeypatch):
    launch, args, counter, bad = case()
    name, wrong = bad["dtype"]
    with pytest.raises(TypeError, match="float32"):
        launch(**{**args, name: wrong})
    name, strided = bad["strided"]
    assert not strided.is_contiguous() and strided.shape == args[name].shape
    with pytest.raises(ValueError, match="contiguous"):
        launch(**{**args, name: strided})
    name, foreign, match = bad["foreign"]
    with pytest.raises(ValueError, match=match):
        launch(**{**args, name: foreign})

    def unbuildable(which):
        raise RuntimeError(f"nvcc not found: {which} cannot be built")

    monkeypatch.setattr(_kernels, "kernel_function", unbuildable)
    before = counter()
    with pytest.raises(RuntimeError, match=kernel):
        launch(**args)
    assert counter() == before
