"""The port's CUDA kernels on the card: each kernel against its plain version,
and the serving path on the card against the same path on the CPU.

Every test here is marked ``cuda`` and skips where no card is visible. The
file imports neither JAX nor networkx (the machine with the card has
neither), so it runs there without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from gn_ode_sir_tpu_torch.graphs.graph import graph_from_edges
from gn_ode_sir_tpu_torch.models.gnode import GNODE
from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
from gn_ode_sir_tpu_torch.ops.spmm2 import CsrPlan, spmm2, spmm2_plain

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(n=300, m=1500, seed=0):
    """A seeded random graph with one hub of degree > 64 (several 32-edge
    batches and a ragged tail in one warp's row walk) and isolated nodes."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n - 5, size=(m, 2))
    hub = np.stack([np.zeros(90, np.int64), rng.integers(1, n - 5, 90)], axis=1)
    return graph_from_edges(n, np.concatenate([pairs, hub]), name="rand")


@pytest.mark.cuda
@pytest.mark.parametrize("h,precision,x_dtype", [
    (64, "f32", torch.float32), (64, "bf16", torch.float32),
    (8, "f32", torch.float32), (100, "f32", torch.bfloat16), (130, "bf16", torch.float32),
    (33, "f32", torch.float32), (33, "bf16", torch.bfloat16)])
def test_spmm2_kernel_matches_plain(cuda_device, h, precision, x_dtype):
    """K1 against its plain version (f32 sums in another order: rtol/atol
    1e-5); the launch is counted, the plain call is not. Even h takes the
    two-wide vector loads, odd h the scalar ones; h = 130 spans three
    column tiles."""
    g = _graph()
    rng = np.random.default_rng(h)
    w = rng.uniform(0.5, 1.5, g.n_edges).astype(np.float32)
    plan = CsrPlan.build(g.src, g.dst, g.n_nodes, w=w, device=cuda_device)
    x = torch.as_tensor(rng.standard_normal((3, g.n_nodes, h)).astype(np.float32),
                        device=cuda_device).to(x_dtype)
    before = spmm2.launches
    got = spmm2(plan, x, precision)
    want = spmm2_plain(plan, x, precision)
    torch.cuda.synchronize()
    assert spmm2.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)
    single = spmm2(plan, x[0].contiguous(), precision)
    np.testing.assert_allclose(single.cpu().numpy(), want[0].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_spmm2_kernel_edgeless_and_rejects(cuda_device):
    plan = CsrPlan.build(np.zeros(0), np.zeros(0), 40, device=cuda_device)
    x = torch.randn(2, 40, 64, device=cuda_device)
    assert torch.count_nonzero(spmm2(plan, x)) == 0
    with pytest.raises(ValueError, match="contiguous"):
        spmm2(plan, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError):
        spmm2(plan, x.half())
    with pytest.raises(ValueError, match="plan lies"):
        spmm2(CsrPlan.build(np.zeros(0), np.zeros(0), 40, device="cpu"), x)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pallas2", "dense"])
def test_gnode_predict_on_card_matches_cpu(cuda_device, kind):
    g = _graph()
    model = GNODE(hidden=16)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    i0 = np.zeros((2, g.n_nodes), np.float32)
    i0[0, [0, 7]] = 1.0
    i0[1, 30] = 1.0
    xs = [1 - i0, i0, np.zeros_like(i0), np.array([0.3, 0.2], np.float32),
          np.array([0.1, 0.4], np.float32)]
    outs = []
    for dev in ("cpu", cuda_device):
        p = {k: {kk: vv.to(dev) for kk, vv in v.items()} for k, v in params.items()}
        with torch.inference_mode():
            outs.append(model.predict(p, adjacency_from_graph(g, kind=kind, device=dev),
                                      *(torch.as_tensor(a, device=dev) for a in xs)).cpu())
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=ATOL)
