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

The recursion holds its edge state scenario-minor: theta, phi and Ps_ij
[E, trials], the node product and Ps(0) [n, trials], so that the node
product's scatter sends a warp's lanes to adjacent scenarios of one node
and the gathers at an edge's reverse edge and source read contiguous rows.
A step takes the node product once (``segment_prod``, one
``scatter_reduce_``) and then two fused kernels, ``ops/dmp_step.py``: K5
writes the marginals into the output [trials, n, 3] and K4 updates phi and
Ps_ij in place and computes theta for the next step (on the CPU their plain
versions, which :func:`_step` runs too, bit for bit).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gn_ode_sir_tpu_torch.ops.dmp_step import (cavity, dmp_marginals, dmp_marginals_plain,
                                               dmp_step, dmp_step_plain)
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
    """The recursion's edge structure on one device: ``src`` and
    ``reverse`` (each edge's reverse edge, -1 where it has none) as int32
    tensors [E], the kernels' indices; ``dst`` as a long tensor [E], the node
    product's scatter index."""

    src: torch.Tensor
    dst: torch.Tensor
    reverse: torch.Tensor
    n_nodes: int

    @classmethod
    def build(cls, src, dst, cave, n_nodes: int, *, device) -> "DmpEdges":
        """From host arrays and :func:`cave_index`'s ``cave``. Refuses a
        repeated directed edge: its reverse would hold two cavity terms."""
        src, dst, cave = (np.asarray(a, dtype=np.int64) for a in (src, dst, cave))
        E = src.shape[0]
        if E and np.bincount(cave, minlength=E + 1)[:E].max() > 1:
            raise ValueError("DMP needs a graph without repeated directed edges")
        on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        return cls(src=on(src, torch.int32), dst=on(dst, torch.long),
                   reverse=on(np.where(cave == E, -1, cave), torch.int32), n_nodes=int(n_nodes))

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def _cavity(theta: torch.Tensor, edges: DmpEdges) -> torch.Tensor:
    """The reverse edge's theta for every edge, 1 where there is none: the
    one factor each cavity product leaves out of the node's full product."""
    return cavity(theta, edges.reverse)


@dataclasses.dataclass(frozen=True)
class _Constants:
    """What every step of :func:`_step` reads: the edges, the rates and
    Ps(0) at the nodes, each [..., trials] (``w`` [E or 1, trials or 1],
    ``gamma`` [n or 1, trials or 1], ``ps_0`` [n, trials])."""

    edges: DmpEdges
    w: torch.Tensor
    gamma: torch.Tensor
    ps_0: torch.Tensor


def _step(theta, phi, ps_ij, prev, c, *, first: bool):
    """One time step, by the plain versions of K5 and K4. In: theta at t-1
    (1 before the first step), phi and Ps_ij at t-1 ([E, trials]), the
    marginals [trials, n, 3] at t-1. Out: theta, phi, Ps_ij and the marginals
    at t."""
    theta = theta - c.w * phi
    if first:
        theta = theta + 1e-10  # the reference's guard at t = 1
    node = segment_prod(theta, c.edges.dst, c.edges.n_nodes)
    marg, pair = node.new_empty((*node.shape[::-1], 3)), node.new_empty((*node.shape, 2))
    dmp_marginals_plain(marg, prev, node, c.ps_0, c.gamma, pair)
    phi, ps_ij = phi.clone(), ps_ij.clone()
    dmp_step_plain(theta, None, phi, ps_ij, pair, c.w, c.gamma, c.edges.src, c.edges.reverse,
                   cav=_cavity(theta, c.edges))
    return theta, phi, ps_ij, marg


_OWN_STEP, _OWN_CAVITY = _step, _cavity


def _fused() -> bool:
    """Whether :func:`dmp_recursion` takes the node product, K5 and K4
    (their plain versions on the CPU): whenever :func:`_step` and
    :func:`_cavity` are the module's own.

    The benchmark's DMP faults and control replace ``_step`` or ``_cavity``,
    so under them the recursion loops :func:`_step`, not the kernels. A
    stopgap, as for K3 (PERF.md, Open questions): it goes once they are
    planted on ``ops.dmp_step``."""
    return _step is _OWN_STEP and _cavity is _OWN_CAVITY


def _fused_steps(out, edges: DmpEdges, w, gamma, ps_0, max_time: int) -> None:
    """Steps 1 .. max_time - 1 into ``out`` [max_time, B, n, 3] (``out[0]``
    written) from ``ps_0`` [n, B] and the rates ``w`` [E or 1, B or 1] and
    ``gamma`` [n or 1, B or 1]: the node product, K5 (which also puts the
    node product and Ps(0) side by side, K4's one gather at an edge's
    source), K4 a step. theta at t = 1 (with the reference's guard) comes
    from the plain ops, once."""
    n = ps_0.shape[0]
    ps_ij = ps_0.index_select(0, edges.src)  # Ps_ij(0) = Ps_i(0), then in place
    phi = 1.0 - ps_ij
    theta = (1.0 - w * phi) + 1e-10  # the reference's guard at t = 1
    spare = torch.empty_like(theta) if max_time > 2 else None
    pair = torch.empty((*ps_0.shape, 2), dtype=ps_0.dtype, device=ps_0.device)
    for t in range(1, max_time):
        node = segment_prod(theta, edges.dst, n)
        dmp_marginals(out[t], out[t - 1], node, ps_0, gamma, pair)
        last = t == max_time - 1
        dmp_step(theta, None if last else spare, phi, ps_ij, pair, w, gamma, edges.src,
                 edges.reverse)
        theta, spare = spare, theta


def _step_loop(out, edges: DmpEdges, w, gamma, ps_0, max_time: int) -> None:
    """What :func:`_fused_steps` computes, a :func:`_step` a time step."""
    c = _Constants(edges=edges, w=w, gamma=gamma, ps_0=ps_0)
    ps_ij = ps_0.index_select(0, edges.src)
    theta, phi = torch.ones((), dtype=ps_0.dtype, device=ps_0.device), 1.0 - ps_ij
    for t in range(1, max_time):
        theta, phi, ps_ij, out[t] = _step(theta, phi, ps_ij, out[t - 1], c, first=t == 1)


def dmp_recursion(edges: DmpEdges, w, gamma, seeds, *, max_time: int) -> torch.Tensor:
    """The recursion on ``edges``' device. ``w``: [..., E] or [..., 1];
    ``gamma`` and ``seeds``: [..., n] or [..., 1], with the same leading
    axes. Returns [max_time, ..., n, 3] (t = 0 .. max_time - 1). The rates
    and Ps(0) are transposed to the recursion's scenario-minor layout once,
    here. ``dmp_recursion.edge_updates`` counts the edge updates run since
    import: trials x E for every time step."""
    if max_time < 1:
        raise ValueError(f"max_time must be >= 1, got {max_time}")
    lead = torch.broadcast_shapes(w.shape[:-1], gamma.shape[:-1], seeds.shape[:-1])
    n = edges.n_nodes
    out = torch.empty((max_time, *lead, n, 3), dtype=seeds.dtype, device=seeds.device)
    ps_0 = 1.0 - seeds
    torch.stack([ps_0, seeds, torch.zeros_like(seeds)], dim=-1, out=out[0])
    if max_time == 1:
        return out
    trials = int(np.prod(lead, dtype=np.int64))
    minor = lambda x: x.expand(*lead, x.shape[-1]).reshape(trials, x.shape[-1]).t().contiguous()
    steps = _fused_steps if _fused() else _step_loop
    steps(out.view(max_time, trials, n, 3), edges, minor(w), minor(gamma), minor(ps_0),
          max_time)
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
