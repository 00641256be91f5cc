"""DMP — Dynamic Message Passing analytic SIR baseline (port of
``gn_ode_sir_tpu.models.dmp``).

The cavity-method edge-message recursion on segment products; the time
recursion is a Python loop of tensor ops, with an optional leading batch
axis over trials.

Message updates (per directed edge i->j, weight w = beta):
  theta_ij(t) = theta_ij(t-1) - w * phi_ij(t-1)
  Ps_ij(t)    = Ps_i(0) * prod_{k in N(i) \\ j} theta_ki(t)
  phi_ij(t)   = (1-w)(1-gamma_i) phi_ij(t-1) - (Ps_ij(t) - Ps_ij(t-1))
Marginals:
  Ps_i(t) = Ps_i(0) * prod_{k in N(i)} theta_ki(t)
  Pr_i(t) = Pr_i(t-1) + gamma_i * Pi_i(t-1)
  Pi_i(t) = 1 - Ps_i(t) - Pr_i(t)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gn_ode_sir_tpu_torch.ops.segment import segment_prod


def cave_index(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Index of each directed edge's reverse edge; E (sentinel) if absent."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    E = src.shape[0]
    n = int(max(src.max(initial=0), dst.max(initial=0))) + 1 if E else 1
    code = src * n + dst
    rev_code = dst * n + src
    order = np.argsort(code)
    pos = np.searchsorted(code[order], rev_code)
    pos = np.clip(pos, 0, E - 1)
    found = code[order][pos] == rev_code
    cave = np.where(found, order[pos], E)
    return cave.astype(np.int32)


def _dmp_run(src, dst, cave, w, gamma, seeds, *, n_nodes: int, max_time: int):
    """The recursion. ``src``/``dst``/``cave``: long [E]; ``w`` [..., E],
    ``gamma`` and ``seeds`` [..., n] with the same leading axes. Returns
    [..., max_time, n, 3]."""
    if max_time < 1:
        raise ValueError(f"max_time must be >= 1, got {max_time}")
    E = src.shape[0]
    edge_dim = w.dim() - 1
    gamma_src = gamma[..., src]

    def node_prod(theta):
        return segment_prod(theta, dst, n_nodes, dim=edge_dim)

    def mulmul(theta):
        # prod over incoming edges at each node / cavity (reverse-edge) term
        theta_cav = segment_prod(theta, cave, E + 1, dim=edge_dim)[..., :E]
        return node_prod(theta)[..., src] / theta_cav

    ps_0 = 1.0 - seeds
    pi_0 = seeds
    pr_0 = torch.zeros_like(seeds)
    out = [torch.stack([ps_0, pi_0, pr_0], dim=-1)]
    if max_time > 1:
        ps_i0 = ps_0[..., src]
        phi0 = 1.0 - ps_i0
        # t = 1
        theta = 1.0 - w * phi0 + 1e-10
        ps_ij = ps_i0 * mulmul(theta)
        phi = (1.0 - w) * (1.0 - gamma_src) * phi0 - (ps_ij - ps_i0)
        ps_t = ps_0 * node_prod(theta)
        pr_t = pr_0 + gamma * pi_0
        pi_t = 1.0 - ps_t - pr_t
        out.append(torch.stack([ps_t, pi_t, pr_t], dim=-1))
        for _ in range(max_time - 2):
            theta = theta - w * phi
            new_ps_ij = ps_i0 * mulmul(theta)
            phi = (1.0 - w) * (1.0 - gamma_src) * phi - (new_ps_ij - ps_ij)
            ps_ij = new_ps_ij
            ps_t = ps_0 * node_prod(theta)
            pr_t = pr_t + gamma * pi_t
            pi_t = 1.0 - ps_t - pr_t
            out.append(torch.stack([ps_t, pi_t, pr_t], dim=-1))
    return torch.stack(out, dim=-3)


@dataclasses.dataclass(frozen=True)
class DMPSIR:
    """Closed-form DMP inference on one graph.

    Construct once per graph (the edge structure is precomputed on the
    host), then call :meth:`run` per trial or :meth:`run_many` per batch of
    trials.
    """

    src: np.ndarray
    dst: np.ndarray
    cave: np.ndarray
    n_nodes: int

    @classmethod
    def from_graph(cls, graph) -> "DMPSIR":
        return cls(
            src=np.asarray(graph.src),
            dst=np.asarray(graph.dst),
            cave=cave_index(graph.src, graph.dst),
            n_nodes=graph.n_nodes,
        )

    def _run(self, seeds, w, gamma, max_time, device):
        on = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt, device=device)  # a copy: broadcasts are read-only
        with torch.no_grad():
            return _dmp_run(
                on(self.src, torch.long), on(self.dst, torch.long), on(self.cave, torch.long),
                on(w, torch.float32), on(gamma, torch.float32), on(seeds, torch.float32),
                n_nodes=self.n_nodes, max_time=max_time)

    def run(self, seed_nodes, beta, gamma, max_time: int = 20, *, device):
        """Marginals [max_time, n_nodes, 3] (S, I, R), starting at t=0, as a
        tensor on ``device``.

        ``beta`` is a scalar transmission probability or a per-edge weight
        array [E] (aligned with ``src``/``dst``); ``gamma`` is a scalar
        recovery probability or a per-node array [n_nodes].
        """
        seeds = np.zeros(self.n_nodes, np.float32)
        seeds[np.asarray(seed_nodes)] = 1.0
        w = np.broadcast_to(np.asarray(beta, np.float32), (self.src.shape[0],))
        g = np.broadcast_to(np.asarray(gamma, np.float32), (self.n_nodes,))
        return self._run(seeds, w, g, max_time, device)

    def run_many(self, seed_sets, betas, gammas, max_time: int = 20, *, device):
        """Marginals [B, max_time, n_nodes, 3] for B trials at once: the
        recursion of :meth:`run` with a leading batch axis. ``betas`` is [B]
        scalars or [B, E] per-edge weights; ``gammas`` is [B] scalars or
        [B, n] per node.
        """
        B = len(seed_sets)
        E = self.src.shape[0]
        seeds = np.zeros((B, self.n_nodes), np.float32)
        for k, s in enumerate(seed_sets):
            seeds[k, np.asarray(list(s), dtype=np.int64)] = 1.0
        w = np.broadcast_to(
            np.asarray(betas, np.float32).reshape(B, -1), (B, E))
        g = np.broadcast_to(
            np.asarray(gammas, np.float32).reshape(B, -1), (B, self.n_nodes))
        return self._run(seeds, w, g, max_time, device)
