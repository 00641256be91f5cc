"""The GN-ODE written out in plain PyTorch, float32 with TF32 off: the
reference of the GN-ODE cells. It imports nothing of the program.

    encode   E_c = relu(W_enc c0 + b_enc),  c in {S, I, R}
    field    Z_c = sigmoid(W_f E_c + b_f);  AI = A Z_I  (a gather and an
             ``index_add_`` over the directed edge list)
             dS = -beta AI Z_S,  dI = -dS - gamma Z_I,  dR = gamma Z_I
    solve    euler from t = 0 to the last label time, max_time - 1
    decode   p_c = W_d2 relu(W_d1 y_c + b_d1) + b_d2, softmax over (S, I, R)
             at the integer times 0 .. max_time - 1
    loss     mean |p - label| over t >= 1, nodes, channels and real trials
    Adam     torch's defaults (0.9, 0.999, 1e-8), written out: one step from
             given moments

Parameters use the layout ``{"enc"|"func"|"dec1"|"dec2": {"w": [in, out],
"b": [out]}}``.
"""

from __future__ import annotations

import contextlib

import torch

LEAVES = (("enc", "w"), ("enc", "b"), ("func", "w"), ("func", "b"),
          ("dec1", "w"), ("dec1", "b"), ("dec2", "w"), ("dec2", "b"))


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the duration (restored after)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def neighbour_sum(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b, d] = sum over edges (s -> d) of x[b, s]; x [B, n, h]."""
    return torch.zeros_like(x).index_add_(1, dst, x.index_select(1, src))


def _lin(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def predict(p: dict, src, dst, s0, i0, r0, beta, gamma, *, delta_t: float,
            max_time: int) -> torch.Tensor:
    """Probabilities [max_time, B, n, 3] at the integer times; s0, i0, r0
    [B, n], beta and gamma [B]."""
    enc = lambda c: torch.relu(_lin(p["enc"], c[..., None]))
    s, i, r = enc(s0), enc(i0), enc(r0)
    b, g = beta[:, None, None], gamma[:, None, None]
    per_unit = round(1 / delta_t)
    steps = round((max_time - 1) / delta_t)  # up to the last integer time
    kept = [(s, i, r)]
    for k in range(1, steps + 1):
        zs = torch.sigmoid(_lin(p["func"], s))
        zi = torch.sigmoid(_lin(p["func"], i))
        ds = -b * neighbour_sum(src, dst, zi) * zs
        di = -ds - g * zi
        dr = g * zi
        s, i, r = s + delta_t * ds, i + delta_t * di, r + delta_t * dr
        if k % per_unit == 0:
            kept.append((s, i, r))
    y = torch.stack([torch.stack(c, dim=-2) for c in kept])  # [T, B, n, 3, h]
    logits = _lin(p["dec2"], torch.relu(_lin(p["dec1"], y)))[..., 0]
    return torch.softmax(logits, dim=-1)


def l1_loss(pred: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Mean |pred - label| over t >= 1; pred [T, B, n, 3], labels [B, T, n,
    3], weight [B] (0 on a padding trial)."""
    err = (pred.permute(1, 0, 2, 3)[:, 1:] - labels[:, 1:]).abs()
    per_trial = err.sum(dim=(1, 2, 3))
    return (per_trial * weight).sum() / (weight.sum() * err[0].numel())


def summaries(probs: torch.Tensor) -> torch.Tensor:
    """[B, 3] in float64: the peak of the mean infected probability, its
    first time, and the final mean recovered probability; plus the curve of
    mean infected probability [T, B] that a peak time is judged against."""
    i_t = probs[..., 1].double().mean(dim=2)
    peak, when = i_t.max(dim=0)
    final_r = probs[-1, :, :, 2].double().mean(dim=1)
    return torch.stack([peak, when.double(), final_r], dim=1), i_t


def loss_and_grad(params: dict, step: dict, *, delta_t: float, max_time: int):
    """One training step's loss and gradient per leaf at ``params``;
    ``step``: src, dst, s0, i0, r0, beta, gamma, labels, weight."""
    leaves = {k: params[k[0]][k[1]].detach().clone().requires_grad_(True) for k in LEAVES}
    tree: dict = {}
    for (layer, name), t in leaves.items():
        tree.setdefault(layer, {})[name] = t
    with float32_exact():
        pred = predict(tree, step["src"], step["dst"], step["s0"], step["i0"], step["r0"],
                       step["beta"], step["gamma"], delta_t=delta_t, max_time=max_time)
        loss = l1_loss(pred, step["labels"], step["weight"])
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def adam(param, grad, exp_avg, exp_avg_sq, step: int, *, lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> torch.Tensor:
    """The parameter after Adam's step number ``step`` (1-based) from its
    moments before it."""
    m = b1 * exp_avg + (1 - b1) * grad
    v = b2 * exp_avg_sq + (1 - b2) * grad * grad
    return param - lr * (m / (1 - b1 ** step)) / ((v / (1 - b2 ** step)).sqrt() + eps)
