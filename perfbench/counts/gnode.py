"""Floating-point operations of the GN-ODE (``models/gnode.py``), op by op.

Counted: the matrix products (two operations a multiply-add) of the encoder,
of the vector field's hidden linear on the stacked (S, I) channels (Z_R never
enters the field, so two channels, not three), K1's adjacency product, and
the decoder at the label times; the backward pass as the products it takes,
each counted once: a linear layer's input gradient where its input needs
one and its weight gradient, and one K1-bwd apply (A^T g) for the adjacency,
which is not differentiated. Elementwise work, reductions and the optimiser
are not counted, so a share of the peak from these counts is a lower bound.
``n`` is the graph's own node count and ``batch`` the real trials: padding
rows and padding trials are not work these inputs need.
"""


def _mm(rows: int, k: int, cols: int) -> float:
    return 2.0 * rows * k * cols


def forward_flops(*, n: int, edges: int, batch: int, hidden: int, evals: int,
                  label_times: int, encode_r: bool = True) -> float:
    """One forward pass: ``evals`` field evaluations, the decoder at
    ``label_times`` times."""
    bn, h = batch * n, hidden
    enc = (3 if encode_r else 2) * _mm(bn, 1, h)
    field = evals * (_mm(2 * bn, h, h) + 2.0 * edges * batch * h)
    rows = label_times * bn * 3
    dec = _mm(rows, h, 4) + _mm(rows, 4, 1)
    return enc + field + dec


def backward_flops(*, n: int, edges: int, batch: int, hidden: int, evals: int,
                   label_times: int, encode_r: bool = True) -> float:
    """The backward pass of one training step, op by op."""
    bn, h = batch * n, hidden
    enc = (3 if encode_r else 2) * _mm(1, bn, h)  # weight gradients only
    field = evals * (2 * _mm(2 * bn, h, h) + 2.0 * edges * batch * h)
    rows = label_times * bn * 3
    dec = 2 * _mm(rows, h, 4) + 2 * _mm(rows, 4, 1)
    return enc + field + dec


def train_step_flops(**shape) -> float:
    return forward_flops(**shape) + backward_flops(**shape)
