"""K4 and K5: DMP's time step around the node product, as two CUDA kernels.

One step of ``models/dmp.py::dmp_recursion`` from t - 1 to t, per scenario,
after the node product ``node = segment_prod(theta(t), dst, n)``. The edge
state is scenario-minor: theta, phi and Ps_ij are [E, B], the node product,
Ps(0) and the pair [n, B] (a warp's lanes walk the scenarios of one edge or
node); the marginals keep the serving contract's [B, n, 3].

    K5 (:func:`dmp_marginals`), per node, into out[t] [B, n, 3]:
        Ps = Ps(0) * node,  Pr = Pr(t-1) + gamma * Pi(t-1),  Pi = 1 - Ps - Pr
        and (node, Ps(0)) side by side into ``pair`` [n, B, 2], for K4
    K4 (:func:`dmp_step`), per directed edge e = i -> j:
        Ps_ij = Ps_i(0) * (node[i] / theta[reverse(e)])   (1 where e has none)
        phi   = (1 - w)(1 - gamma_i) * phi - (Ps_ij - Ps_ij(t-1))
        theta(t+1) = theta(t) - w * phi

``phi`` and ``ps_ij`` are updated in place; theta at t + 1 goes to a second
buffer (the cavity gather reads other edges' theta at t), or nowhere at the
last step. Rates are per scenario ([1, B]) or per edge / per node ([E, B] /
[n, B]); a 1 broadcasts.

They replace no TPU kernel: the JAX package leaves DMP's step to XLA, which
fuses it on the TPU; in eager PyTorch it was about twelve passes over
the edge state and six node-sized kernels and a stack. The kernels,
``gn_ode_sir_tpu_torch/csrc/dmp_step.cu``, read theta, phi and Ps_ij once
and write them once (24 B an edge update): 0.33 ms for K4 at [361,622, 128]
at an H100's 3.35 TB/s. In the scenario-minor layout its two gathers (theta
of the reverse edge, the pair at the source) read contiguous rows of B
scenarios (the source's notes).

Beside them, their plain PyTorch versions, :func:`dmp_step_plain` and
:func:`dmp_marginals_plain`: the recursion's step in PyTorch ops, which
``models/dmp.py::_step`` runs as they are. Every product, quotient and difference
of the kernels rounds as these ops round, so, fed the same node product, the
two give the same bits. The wrappers take the plain versions only for CPU
tensors; a CUDA tensor launches the kernel or raises. ``dmp_step.launches``
counts K4's launches, ``dmp_marginals.launches`` K5's (CPU calls do not
count).
"""

from __future__ import annotations

import torch

from gn_ode_sir_tpu_torch.ops import _kernels


def cavity(theta, reverse):
    """The reverse edge's theta row for every edge, 1 where ``reverse`` is
    -1: the one factor each cavity product leaves out of the node's product."""
    return theta.index_select(0, reverse.clamp(min=0)).masked_fill_((reverse < 0)[:, None], 1.0)


def dmp_step_plain(theta, theta_next, phi, ps_ij, pair, w, gamma, src, reverse, *,
                   cav=None) -> None:
    """The plain PyTorch version of K4: the edge update from the node product
    and Ps(0) in ``pair``, with theta at t + 1 written into ``theta_next``
    (where given). ``cav``: the cavity factors, where the caller has its own
    (``models/dmp.py::_step``); else :func:`cavity` of ``theta``."""
    node, ps_0 = pair[..., 0], pair[..., 1]
    cav = cavity(theta, reverse) if cav is None else cav
    new_ps_ij = ps_0.index_select(0, src) * (node.index_select(0, src) / cav)
    gamma_src = gamma if gamma.shape[0] == 1 else gamma.index_select(0, src)
    decay = (1.0 - w) * (1.0 - gamma_src)
    phi.copy_(decay * phi - (new_ps_ij - ps_ij))
    ps_ij.copy_(new_ps_ij)
    if theta_next is not None:
        torch.sub(theta, w * phi, out=theta_next)


def dmp_marginals_plain(out, prev, node, ps_0, gamma, pair) -> None:
    """The plain PyTorch version of K5: the marginals at t from
    those at t - 1, stacked into ``out``; (node, Ps(0)) into ``pair``."""
    ps_t = (ps_0 * node).t()
    pr_t = prev[..., 2] + gamma.t() * prev[..., 1]
    pi_t = 1.0 - ps_t - pr_t
    torch.stack([ps_t, pi_t, pr_t], dim=-1, out=out)
    torch.stack([node, ps_0], dim=-1, out=pair)


def _shaped(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")


def _rate(name, t, rows, b):
    """A rate [rows or 1, B or 1]."""
    if t.dim() != 2 or t.shape[0] not in (1, rows) or t.shape[1] not in (1, b):
        raise ValueError(f"{name} must be [{rows} or 1, {b} or 1], got {list(t.shape)}")


def _strides(t) -> tuple[int, int]:
    """(row stride, scenario stride) of a rate, 0 where it broadcasts."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError("dmp_step kernels take rates contiguous along their last axis")
    return (0 if t.shape[0] == 1 else t.stride(0)), (0 if t.shape[1] == 1 else 1)


def _launch_step(theta, theta_next, phi, ps_ij, pair, w, gamma, src, reverse) -> None:
    state = (theta, phi, ps_ij, pair) + (() if theta_next is None else (theta_next,))
    _kernels.check("dmp_step", theta.device, [((torch.float32,), (*state, w, gamma)),
                                              ((torch.int32,), (src, reverse))],
                   (*state, src, reverse))
    if theta_next is not None and theta_next.data_ptr() == theta.data_ptr():
        raise ValueError("dmp_step writes theta at t + 1 beside theta at t, not over it")
    if not theta.numel():
        return
    (e, b), n = theta.shape, pair.shape[0]
    w_se, w_sb = _strides(w)
    g_sn, g_sb = _strides(gamma)
    _kernels.launch("dmp_edge_step", theta.device, theta.data_ptr(),
                    None if theta_next is None else theta_next.data_ptr(), phi.data_ptr(),
                    ps_ij.data_ptr(), pair.data_ptr(), src.data_ptr(), reverse.data_ptr(),
                    w.data_ptr(), w_se, w_sb, gamma.data_ptr(), g_sn, g_sb, b, e, n)
    dmp_step.launches += 1


def _launch_marginals(out, prev, node, ps_0, gamma, pair) -> None:
    state = (out, prev, node, ps_0, pair)
    _kernels.check("dmp_marginals", node.device, [((torch.float32,), (*state, gamma))], state)
    if not node.numel():
        return
    n, b = node.shape
    g_sn, g_sb = _strides(gamma)
    _kernels.launch("dmp_marginals", node.device, out.data_ptr(), prev.data_ptr(),
                    node.data_ptr(), ps_0.data_ptr(), pair.data_ptr(), gamma.data_ptr(), g_sn,
                    g_sb, b, n)
    dmp_marginals.launches += 1


def dmp_step(theta, theta_next, phi, ps_ij, pair, w, gamma, src, reverse) -> None:
    """K4: the edge update of one DMP step. ``theta`` [E, B] (at t),
    ``theta_next`` [E, B] or None (no theta at t + 1, the last step), ``phi``
    and ``ps_ij`` [E, B] updated in place, ``pair`` [n, B, 2] (the node
    product and Ps(0), as :func:`dmp_marginals` writes them), ``w`` [E or 1,
    B or 1], ``gamma`` [n or 1, B or 1], ``src`` and ``reverse`` [E]
    (``reverse`` -1 where an edge has none).

    A CUDA tensor launches the kernel (float32, int32 indices, contiguous,
    or it raises); a CPU tensor takes :func:`dmp_step_plain`."""
    if theta.dim() != 2 or pair.dim() != 3:
        raise ValueError(f"theta must be [E, B] and pair [n, B, 2], got "
                         f"{list(theta.shape)} and {list(pair.shape)}")
    e, b = theta.shape
    n = pair.shape[0]
    for name, t, shape in (("phi", phi, (e, b)), ("ps_ij", ps_ij, (e, b)),
                           ("pair", pair, (n, b, 2)), ("src", src, (e,)),
                           ("reverse", reverse, (e,))) + (
            () if theta_next is None else (("theta_next", theta_next, (e, b)),)):
        _shaped(name, t, shape)
    _rate("w", w, e, b)
    _rate("gamma", gamma, n, b)
    if _kernels.on_cuda("dmp_step", theta.device):
        return _launch_step(theta, theta_next, phi, ps_ij, pair, w, gamma, src, reverse)
    return dmp_step_plain(theta, theta_next, phi, ps_ij, pair, w, gamma, src, reverse)


def dmp_marginals(out, prev, node, ps_0, gamma, pair) -> None:
    """K5: the marginals of one DMP step, written into ``out`` [B, n, 3]
    (S, I, R at t) from ``prev`` [B, n, 3] (at t - 1), the node product
    ``node`` and ``ps_0`` [n, B] and ``gamma`` [n or 1, B or 1]; and the node
    product and Ps(0) side by side into ``pair`` [n, B, 2], for
    :func:`dmp_step`.

    A CUDA tensor launches the kernel (float32, contiguous, or it raises); a
    CPU tensor takes :func:`dmp_marginals_plain`."""
    if node.dim() != 2:
        raise ValueError(f"node must be [n, B], got {list(node.shape)}")
    n, b = node.shape
    for name, t, shape in (("out", out, (b, n, 3)), ("prev", prev, (b, n, 3)),
                           ("ps_0", ps_0, (n, b)), ("pair", pair, (n, b, 2))):
        _shaped(name, t, shape)
    _rate("gamma", gamma, n, b)
    if _kernels.on_cuda("dmp_marginals", node.device):
        return _launch_marginals(out, prev, node, ps_0, gamma, pair)
    return dmp_marginals_plain(out, prev, node, ps_0, gamma, pair)


dmp_step.launches = 0  # K4 launches since the last reset (CPU calls do not count)
dmp_marginals.launches = 0  # K5 launches, likewise
