"""The operation and byte counts against hand counts, and the GN-ODE's
matrix-product count against torch's own FLOP counter on the reference."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import inputs
from perfbench.counts import gnode, labels, spmm
from perfbench.reference import gnode as ref

SHAPE = dict(n=3, edges=4, batch=2, hidden=5, evals=2, label_times=3, encode_r=True)


def test_gnode_hand_counts():
    # encoder 3 x 2*6*1*5; field 2 x (2*12*5*5 + 2*4*2*5); decoder
    # 2*54*5*4 + 2*54*4*1, with 54 = 3 times x 6 node-trials x 3 channels
    assert gnode.forward_flops(**SHAPE) == 180 + 2 * (600 + 80) + 2160 + 432
    # weight gradients of the encoder; input and weight gradients of the
    # field's linear and of the decoder; one K1-bwd apply an evaluation
    assert gnode.backward_flops(**SHAPE) == 180 + 2 * (1200 + 80) + 2 * 2160 + 2 * 432
    assert gnode.train_step_flops(**SHAPE) == 4132 + 7924


def test_k1_and_label_hand_counts():
    k1 = spmm.k1_apply(n=3, edges=4, batch=2, h=5)
    assert k1["ops"] == 80 and k1["bytes"] == 120 + 32 + 16 + 120
    assert k1["bound_by"] == "bytes"
    cp = labels.count_product(rows=10, n=4)
    assert cp["ops"] == 320 and cp["bytes"] == 40 + 16 + 160
    assert labels.k2_step(rows=10, n=4)["bytes"] == 320


def test_matrix_products_match_torch_flop_counter():
    """torch counts the reference's matrix products (not K1's gather and
    index_add); the counts here, less K1's, must equal them, forward and
    forward plus backward."""
    torch.manual_seed(0)
    n, b, h, evals, times = 9, 2, 4, 6, 4
    src, dst = (torch.as_tensor(a) for a in inputs.directed(inputs.powerlaw_pairs(n, 20, 1)))
    params = inputs.gnode_params(torch.Generator().manual_seed(1), h, "cpu")
    leaves = [params[k][m].requires_grad_(True) for k, m in ref.LEAVES]
    i0 = torch.zeros(b, n)
    i0[:, 0] = 1
    args = (params, src, dst, 1 - i0, i0, torch.zeros_like(i0), torch.full((b,), 0.3),
            torch.full((b,), 0.2))
    shape = dict(n=n, edges=len(src), batch=b, hidden=h, evals=evals, label_times=times)
    k1 = evals * 2 * len(src) * b * h
    with FlopCounterMode(display=False) as fwd:
        pred = ref.predict(*args, delta_t=0.5, max_time=times)
    assert fwd.get_total_flops() == gnode.forward_flops(**shape) - k1
    with FlopCounterMode(display=False) as both:
        loss = ref.l1_loss(ref.predict(*args, delta_t=0.5, max_time=times),
                           torch.rand(b, times, n, 3), torch.ones(b))
        torch.autograd.grad(loss, leaves)
    assert both.get_total_flops() == gnode.train_step_flops(**shape) - 2 * k1
    assert pred.shape == (times, b, n, 3)
