"""Every input of a cell, made from the run's seed; the same seed gives the
same inputs, and both the program and the reference get them.

- Graphs: seeded Chung-Lu power-law graphs with exactly the published node
  and directed-edge counts (the real graph pickles are not in the
  repository). :func:`powerlaw_pairs` is ``chip_smoke.py::powerlaw_graph``
  frozen here, up to the undirected pairs; the program builds its ``Graph``
  from them, the reference its own edge index.
- Trials: seed sets, beta and gamma from a numpy generator.
- Parameters and synthetic label trajectories: on the device, from a
  ``torch.Generator`` there, in a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_SEED = 2**63 - 1


def powerlaw_pairs(n: int, n_directed: int, seed: int) -> np.ndarray:
    """[n_directed / 2, 2] undirected pairs of a seeded Chung-Lu power-law
    graph: no self-loops, no duplicates, node ids shuffled."""
    rng = np.random.default_rng(seed)
    weight = np.arange(1, n + 1, dtype=np.float64) ** -0.55
    weight /= weight.sum()
    want = n_directed // 2
    codes = np.zeros(0, np.int64)
    while codes.size < want:
        pairs = rng.choice(n, size=(int(1.2 * (want - codes.size)) + 64, 2), p=weight)
        a, b = pairs.min(axis=1), pairs.max(axis=1)
        codes = np.unique(np.concatenate([codes, (a * n + b)[a != b]]))
    codes = np.sort(rng.choice(codes, size=want, replace=False))
    perm = rng.permutation(n)
    return np.stack([perm[codes // n], perm[codes % n]], axis=1)


def directed(pairs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Both directions of every pair: (src, dst) int64."""
    return (np.concatenate([pairs[:, 0], pairs[:, 1]]),
            np.concatenate([pairs[:, 1], pairs[:, 0]]))


def graphs(cfg: dict, rng: np.random.Generator) -> list[dict]:
    """One dict per graph of the configuration: name, n, directed edge
    count and pairs."""
    out = []
    for g in cfg["graphs"]:
        pairs = powerlaw_pairs(g["nodes"], g["directed_edges"], int(rng.integers(2**31)))
        out.append({"name": g["name"], "n": g["nodes"], "edges": 2 * len(pairs),
                    "pairs": pairs})
    return out


def trials(rng: np.random.Generator, n: int, count: int, n_i: int, beta, gamma) -> list:
    """``count`` (seed nodes, beta, gamma) scenarios on ``n`` nodes, rates
    uniform in the configuration's ranges."""
    nodes = [sorted(int(v) for v in rng.choice(n, n_i, replace=False)) for _ in range(count)]
    b = rng.uniform(beta[0], beta[1], count)
    g = rng.uniform(gamma[0], gamma[1], count)
    return [(nodes[k], float(b[k]), float(g[k])) for k in range(count)]


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & MAX_SEED)


def gnode_params(gen: torch.Generator, hidden: int, device) -> dict:
    """GN-ODE parameters in the program's layout (``{"w": [in, out], "b":
    [out]}`` per layer), uniform in +-1/sqrt(fan_in) as ``torch.nn.Linear``
    draws them, from one draw on the device."""
    shapes = {"enc": (1, hidden), "func": (hidden, hidden), "dec1": (hidden, 4), "dec2": (4, 1)}
    total = sum(i * o + o for i, o in shapes.values())
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, k = {}, 0
    for name, (i, o) in shapes.items():
        bound = 1.0 / float(np.sqrt(i))
        w, b = u[k:k + i * o], u[k + i * o:k + i * o + o]
        out[name] = {"w": (w * bound).reshape(i, o).contiguous(), "b": (b * bound).contiguous()}
        k += i * o + o
    return out


def synthetic_labels(gen: torch.Generator, count: int, times: int, n: int, device) -> torch.Tensor:
    """[count, times, n, 3] label trajectories: per node S + I + R = 1, R
    non-decreasing in time. Their values do not change a step's work."""
    inc = torch.rand((count, times, n), generator=gen, device=device)
    top = torch.rand((count, 1, n), generator=gen, device=device)
    r = torch.cumsum(inc, dim=1) / inc.sum(dim=1, keepdim=True) * top
    i = (1 - r) * torch.rand((count, times, n), generator=gen, device=device)
    return torch.stack([1 - r - i, i, r], dim=-1)
