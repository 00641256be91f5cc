"""DMP, the dynamic message-passing equations for SIR (Lokhov, Mezard, Ohta
and Zdeborova, Phys. Rev. E 2014; Lokhov, Mezard and Zdeborova, Phys. Rev. E
2015), written out in plain PyTorch: the reference of the DMP cells. It
imports nothing of the program and runs in float64 unless told otherwise.

Per directed edge i -> j (w = beta of the scenario, gamma_i its gamma):
    theta_ij(t) = theta_ij(t-1) - w phi_ij(t-1),       theta_ij(0) = 1
    Ps_ij(t)    = Ps_i(0) prod_{k in N(i) minus j} theta_ki(t)
    phi_ij(t)   = (1 - w)(1 - gamma_i) phi_ij(t-1) - (Ps_ij(t) - Ps_ij(t-1)),
                  phi_ij(0) = 1 - Ps_i(0),  Ps_ij(0) = Ps_i(0)
Per node:
    Ps_i(t) = Ps_i(0) prod_{k in N(i)} theta_ki(t)
    Pr_i(t) = Pr_i(t-1) + gamma_i Pi_i(t-1),   Pi_i(t) = 1 - Ps_i(t) - Pr_i(t)
from Ps_i(0) = 1 - seed, Pi_i(0) = seed, Pr_i(0) = 0.

The cavity product over N(i) minus j is taken by exclusion: the incoming
edges of each node in one segment, inclusive prefix and suffix products
inside it (doubling scans), and the product of all but one edge as the
prefix before it times the suffix after it. No division, so it does not
share the program's way of leaving the reverse edge out. An edge without a
reverse edge takes the node's full product.

The paper's code (``dmp.py`` of the GN-ODE-SIR repository) and the program
add 1e-10 to theta at t = 1, a guard against dividing by a theta of 0. In
float32 it lies below theta's rounding wherever beta < 1 (theta(1) is 1 or 1
- beta phi(0)), so the program computes the published equations. In float64
it is not absorbed: it acts as an infection of -1e-10 on every edge, which
grows at the epidemic's own rate (on a 60-node graph whose seeds had no
edges it moved the final recovered fraction by 6e-3). The reference, which
divides by nothing, follows the published equations and leaves it out.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Segments:
    """The directed edges grouped by destination: ``order`` sorts them so;
    ``pos`` is each sorted edge's place in its segment and ``left`` its
    distance to the segment's end; ``ends`` the last sorted place of every
    non-empty segment and ``owner`` its node; ``rev_at`` the sorted place
    of each edge's reverse edge (any place where ``has_rev`` is False)."""

    n: int
    src: torch.Tensor
    order: torch.Tensor
    pos: torch.Tensor
    left: torch.Tensor
    ends: torch.Tensor
    owner: torch.Tensor
    rev_at: torch.Tensor
    has_rev: torch.Tensor


def segments(src: torch.Tensor, dst: torch.Tensor, n: int) -> Segments:
    """The segment structure of the directed edge list (src, dst)."""
    src, dst = src.long(), dst.long()
    E = src.shape[0]
    order = torch.argsort(dst, stable=True)
    d = dst[order]
    idx = torch.arange(E, device=src.device)
    new = torch.ones(E, dtype=torch.bool, device=src.device)
    new[1:] = d[1:] != d[:-1]
    start = torch.cummax(torch.where(new, idx, 0), 0).values
    last = torch.ones(E, dtype=torch.bool, device=src.device)
    last[:-1] = d[1:] != d[:-1]
    ends = idx[last]
    end_of = torch.flip(torch.cummin(torch.flip(torch.where(last, idx, E), [0]), 0).values, [0])
    place = torch.empty_like(order)
    place[order] = idx
    code = src * n + dst
    by_code = torch.argsort(code)
    at = torch.searchsorted(code[by_code], dst * n + src).clamp(max=max(E - 1, 0))
    has_rev = code[by_code][at] == dst * n + src
    return Segments(n=n, src=src, order=order, pos=idx - start, left=end_of - idx, ends=ends,
                    owner=d[ends], rev_at=place[by_code[at]], has_rev=has_rev)


def _inclusive(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Inclusive product scan along the last axis inside segments; ``pos``:
    each place's distance from its segment's start (Hillis-Steele)."""
    d = 1
    top = int(pos.max()) if pos.numel() else 0
    while d <= top:
        shifted = torch.ones_like(x)
        shifted[..., d:] = x[..., :-d]
        x = torch.where(pos >= d, x * shifted, x)
        d *= 2
    return x


def products(theta: torch.Tensor, seg: Segments) -> tuple[torch.Tensor, torch.Tensor]:
    """(cavity [..., E], full [..., n]) for theta [..., E]: for edge i -> j
    the product over the incoming edges of i but the one from j; for node i
    the product over all its incoming edges (1 for none)."""
    x = theta[..., seg.order]
    pre = _inclusive(x, seg.pos)
    suf = torch.flip(_inclusive(torch.flip(x, [-1]), torch.flip(seg.left, [0])), [-1])
    ones = torch.ones_like(x[..., :1])
    before = torch.cat([ones, pre[..., :-1]], -1).where(seg.pos > 0, ones)
    after = torch.cat([suf[..., 1:], ones], -1).where(seg.left > 0, ones)
    excl = before * after  # sorted places: the product of the segment but this edge
    full = torch.ones((*theta.shape[:-1], seg.n), dtype=theta.dtype, device=theta.device)
    full[..., seg.owner] = pre[..., seg.ends]
    cavity = torch.where(seg.has_rev, excl[..., seg.rev_at], full[..., seg.src])
    return cavity, full


def step(theta, phi, ps_ij, pi, pr, ps0, w, gamma, seg: Segments):
    """One time step: edge state (theta, phi, Ps_ij) and the node marginals
    Pi, Pr at t-1, Ps(0) and the rates ([..., 1]) in; the edge state and (Ps,
    Pi, Pr) at t out."""
    theta = theta - w * phi
    cavity, full = products(theta, seg)
    ps_i0 = ps0[..., seg.src]
    new_ps_ij = ps_i0 * cavity
    g_src = gamma if gamma.shape[-1] == 1 else gamma[..., seg.src]
    phi = (1 - w) * (1 - g_src) * phi - (new_ps_ij - ps_ij)
    s = ps0 * full
    r = pr + gamma * pi
    return theta, phi, new_ps_ij, s, 1 - s - r, r


def predict(src, dst, n: int, seeds, beta, gamma, *, max_time: int, block: int = 16,
            dtype=torch.float64) -> torch.Tensor:
    """Marginals [max_time, B, n, 3] (S, I, R) for seeds [B, n] (1 on the
    seed nodes), beta and gamma [B], in ``dtype``, ``block`` scenarios at a
    time."""
    seg = segments(src, dst, n)
    out = []
    for lo in range(0, seeds.shape[0], block):
        i0 = seeds[lo:lo + block].to(dtype)
        w = beta[lo:lo + block, None].to(dtype)
        g = gamma[lo:lo + block, None].to(dtype)
        ps0 = 1 - i0
        marg = [torch.stack([ps0, i0, torch.zeros_like(i0)], -1)]
        theta = torch.ones((), dtype=dtype, device=i0.device)
        ps_ij = ps0[..., seg.src]
        phi, pi, pr = 1 - ps_ij, i0, torch.zeros_like(i0)
        for t in range(1, max_time):
            theta, phi, ps_ij, s, pi, pr = step(theta, phi, ps_ij, pi, pr, ps0, w, g, seg)
            marg.append(torch.stack([s, pi, pr], -1))
        out.append(torch.stack(marg))
    return torch.cat(out, 1)


def summaries(probs: torch.Tensor) -> torch.Tensor:
    """[T, B, n, 3] -> [B, 3]: peak of the mean infected probability, its
    first time, and the final mean recovered probability."""
    i_t = mean_infected(probs)
    peak = i_t.max(0).values
    times = torch.arange(i_t.shape[0], device=i_t.device)[:, None].expand_as(i_t)
    first = torch.where(i_t == peak, times, i_t.shape[0]).amin(0)
    return torch.stack([peak, first.to(peak.dtype), probs[-1, ..., 2].mean(-1)], 1)


def mean_infected(probs: torch.Tensor) -> torch.Tensor:
    """[T, B]: the mean infected probability at every time."""
    return probs[..., 1].mean(-1)
