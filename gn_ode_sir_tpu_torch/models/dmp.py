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

The cavity product is the node's full product divided by the reverse edge's
theta (1 where the edge has no reverse). The edge structure (``src``,
``dst``, the reverse edge) lives on the device in a :class:`DmpEdges`, built
once per graph and device; rates stay per trial ([B] or [B, 1]) and
broadcast on the device, or are given per edge / per node.
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


@dataclasses.dataclass(frozen=True)
class DmpEdges:
    """The recursion's edge structure on one device: ``src``, ``dst`` and
    ``reverse`` (each edge's reverse edge, 0 where it has none) as long
    tensors [E], ``no_reverse`` (bool [E], None where every edge has one)."""

    src: torch.Tensor
    dst: torch.Tensor
    reverse: torch.Tensor
    no_reverse: torch.Tensor | None
    n_nodes: int

    @classmethod
    def build(cls, src, dst, cave, n_nodes: int, *, device) -> "DmpEdges":
        """From host arrays and :func:`cave_index`'s ``cave``. Refuses a
        repeated directed edge: its reverse would hold two cavity terms."""
        src, dst, cave = (np.asarray(a, dtype=np.int64) for a in (src, dst, cave))
        E = src.shape[0]
        if E and np.bincount(cave, minlength=E + 1)[:E].max() > 1:
            raise ValueError("DMP needs a graph without repeated directed edges")
        missing = cave == E
        on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        return cls(src=on(src, torch.long), dst=on(dst, torch.long),
                   reverse=on(np.where(missing, 0, cave), torch.long),
                   no_reverse=on(missing, torch.bool) if missing.any() else None,
                   n_nodes=int(n_nodes))

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def _cavity(theta: torch.Tensor, edges: DmpEdges) -> torch.Tensor:
    """The reverse edge's theta for every edge, 1 where there is none: the
    one factor each cavity product leaves out of the node's full product."""
    rev = theta.index_select(-1, edges.reverse)
    return rev if edges.no_reverse is None else rev.masked_fill_(edges.no_reverse, 1.0)


@dataclasses.dataclass(frozen=True)
class _Constants:
    """What every step reads: the edges, the rates, Ps(0) at the nodes and
    at each edge's source, and phi's decay (1 - w)(1 - gamma_src)."""

    edges: DmpEdges
    w: torch.Tensor
    gamma: torch.Tensor
    ps_0: torch.Tensor
    ps_i0: torch.Tensor
    decay: torch.Tensor


def _step(theta, phi, ps_ij, pr, pi, c, *, first: bool):
    """One time step. In: theta at t-1 (1 before the first step), phi and
    Ps_ij at t-1, the marginals Pr and Pi at t-1. Out: theta, phi, Ps_ij at t
    and the marginals (Ps, Pi, Pr) at t."""
    theta = theta - c.w * phi
    if first:
        theta = theta + 1e-10  # the reference's guard at t = 1
    node = segment_prod(theta, c.edges.dst, c.edges.n_nodes, dim=-1)
    new_ps_ij = c.ps_i0 * (node.index_select(-1, c.edges.src) / _cavity(theta, c.edges))
    phi = c.decay * phi - (new_ps_ij - ps_ij)
    ps_t = c.ps_0 * node
    pr_t = pr + c.gamma * pi
    pi_t = 1.0 - ps_t - pr_t
    return theta, phi, new_ps_ij, (ps_t, pi_t, pr_t)


def dmp_recursion(edges: DmpEdges, w, gamma, seeds, *, max_time: int) -> torch.Tensor:
    """The recursion on ``edges``' device. ``w``: [..., E] or [..., 1];
    ``gamma`` and ``seeds``: [..., n] or [..., 1], with the same leading
    axes. Returns [max_time, ..., n, 3] (t = 0 .. max_time - 1).
    ``dmp_recursion.edge_updates`` counts the edge updates run since import:
    trials x E for every time step."""
    if max_time < 1:
        raise ValueError(f"max_time must be >= 1, got {max_time}")
    lead = torch.broadcast_shapes(w.shape[:-1], gamma.shape[:-1], seeds.shape[:-1])
    n = edges.n_nodes
    out = torch.empty((max_time, *lead, n, 3), dtype=seeds.dtype, device=seeds.device)
    ps_0 = 1.0 - seeds
    pi_0 = seeds
    pr_0 = torch.zeros_like(seeds)
    torch.stack([ps_0, pi_0, pr_0], dim=-1, out=out[0])
    if max_time == 1:
        return out
    ps_i0 = ps_0.index_select(-1, edges.src)
    gamma_src = gamma if gamma.shape[-1] == 1 else gamma.index_select(-1, edges.src)
    c = _Constants(edges=edges, w=w, gamma=gamma, ps_0=ps_0, ps_i0=ps_i0,
                   decay=(1.0 - w) * (1.0 - gamma_src))
    theta = torch.ones((), dtype=seeds.dtype, device=seeds.device)
    phi, ps_ij, pr, pi = 1.0 - ps_i0, ps_i0, pr_0, pi_0
    for t in range(1, max_time):
        theta, phi, ps_ij, marg = _step(theta, phi, ps_ij, pr, pi, c, first=t == 1)
        torch.stack(marg, dim=-1, out=out[t])
        _, pi, pr = marg
    trials = int(np.prod(lead, dtype=np.int64))
    dmp_recursion.edge_updates += (max_time - 1) * trials * edges.n_edges
    return out


dmp_recursion.edge_updates = 0


@dataclasses.dataclass(frozen=True)
class DMPSIR:
    """Closed-form DMP inference on one graph.

    Construct once per graph (the edge structure is precomputed on the
    host and put on a device once, at its first use there), then call
    :meth:`run` per trial, :meth:`run_many` per batch of trials, or serve it
    as the other models are: ``predict(params, adj, s0, i0, r0, beta,
    gamma)`` with ``adj = model.edges(device)`` and no parameters.
    """

    src: np.ndarray
    dst: np.ndarray
    cave: np.ndarray
    n_nodes: int
    max_time: int = 20  # the serving horizon; run/run_many take their own
    _on: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def from_graph(cls, graph, max_time: int = 20) -> "DMPSIR":
        return cls(
            src=np.asarray(graph.src),
            dst=np.asarray(graph.dst),
            cave=cave_index(graph.src, graph.dst),
            n_nodes=graph.n_nodes,
            max_time=max_time,
        )

    def edges(self, device) -> DmpEdges:
        """The edge structure on ``device``, built at its first use there."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._on:
            self._on[device] = DmpEdges.build(self.src, self.dst, self.cave, self.n_nodes,
                                              device=device)
        return self._on[device]

    def predict(self, params, adj: DmpEdges, s0, i0, r0, beta, gamma) -> torch.Tensor:
        """Serving: [T, B, n, 3] marginals for B scenarios, T =
        ``max_time``. The seeds are ``i0`` [B, n]; DMP starts from S = 1 -
        I and R = 0, which is what ``s0`` and ``r0`` hold in the serving
        contract, and reads neither. ``beta`` and ``gamma``: [B]. DMP has
        no parameters: ``params`` is unread."""
        with torch.no_grad():
            return dmp_recursion(adj, beta[:, None], gamma[:, None], i0, max_time=self.max_time)

    def _run(self, seeds, w, gamma, max_time, device):
        on = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        with torch.no_grad():
            return dmp_recursion(self.edges(device), on(w), on(gamma), on(seeds),
                                 max_time=max_time)

    def run(self, seed_nodes, beta, gamma, max_time: int = 20, *, device):
        """Marginals [max_time, n_nodes, 3] (S, I, R), starting at t=0, as a
        tensor on ``device``.

        ``beta`` is a scalar transmission probability or a per-edge weight
        array [E] (aligned with ``src``/``dst``); ``gamma`` is a scalar
        recovery probability or a per-node array [n_nodes].
        """
        seeds = np.zeros(self.n_nodes, np.float32)
        seeds[np.asarray(seed_nodes)] = 1.0
        return self._run(seeds, np.reshape(beta, -1), np.reshape(gamma, -1), max_time, device)

    def run_many(self, seed_sets, betas, gammas, max_time: int = 20, *, device):
        """Marginals [B, max_time, n_nodes, 3] for B trials at once: the
        recursion of :meth:`run` with a leading batch axis. ``betas`` is [B]
        scalars or [B, E] per-edge weights; ``gammas`` is [B] scalars or
        [B, n] per node.
        """
        B = len(seed_sets)
        seeds = np.zeros((B, self.n_nodes), np.float32)
        for k, s in enumerate(seed_sets):
            seeds[k, np.asarray(list(s), dtype=np.int64)] = 1.0
        out = self._run(seeds, np.reshape(betas, (B, -1)), np.reshape(gammas, (B, -1)),
                        max_time, device)
        return out.movedim(0, 1)
