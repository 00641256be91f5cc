"""Vectorized Monte-Carlo SIR simulator (port of ``gn_ode_sir_tpu.sim.mc_sir``).

The process: at each step every infected node tries to infect each
susceptible neighbour with probability beta, and every node infected at the
start of the step recovers with probability gamma. A susceptible node with k
infected neighbours is therefore infected with probability 1 - (1 - beta)^k,
which needs only the infected-neighbour COUNT (one dense product I @ A with
the {0,1} adjacency) and one random word per node. All simulations of all
trials of a dispatch advance together as one [trials * sims, n] int8 matrix;
per-step indicator sums are taken on the fly, so memory does not grow with T.
Only (I, R) are carried: S = 1 - I - R.

The count product must be exact (a hub has more than 256 neighbours, which a
bf16 result cannot hold). ``matmul``:
- ``'int8'``: ``torch._int_mm``, int8 operands and int32 sums;
- ``'bf16'``: bf16 operands, f32 sums and f32 output;
- ``'auto'``: on a card ``'int8'``, the faster of the two as measured at
  enron size (PERF.md); on the CPU a float32 product (exact below 2^24)
  under every name.

``coins``: ``'auto'``, ``'bits16'``, ``'rbg16'`` and ``'pallas'`` all name
the one fused path (K2, :mod:`gn_ode_sir_tpu_torch.sim.fused_step`): one
Philox word per node, the low 16 bits decide infection and the high 16 bits
recovery. ``'bits32'`` (two 32-bit words) and ``'uniform'`` (two f32
uniforms) are plain torch ops drawing from a ``torch.Generator`` seeded per
trial. Seeds are Python integers in [0, 2^63) where the JAX package takes
PRNG keys; the two packages draw different, equally valid streams.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.sim.fused_step import MAX_SEED, sir_step
from gn_ode_sir_tpu_torch.utils.profiling import span

_COIN_MODES = ("auto", "bits16", "rbg16", "bits32", "uniform", "pallas")
_FUSED_COINS = ("auto", "bits16", "rbg16", "pallas")
_MATMULS = ("auto", "bf16", "int8")
# `auto` on a card: torch._int_mm with a column-major adjacency ran 2.2x
# faster than the bf16 product at enron size on an H100 (PERF.md §6)
CUDA_AUTO_MATMUL = "int8"
_MASK64 = 2**64 - 1


def _resolve_coins(coins: str) -> str:
    """The name recorded beside a label cache: 'philox16' for every name of
    the fused path, else the mode itself."""
    if coins not in _COIN_MODES:
        raise ValueError(f"coins must be one of {_COIN_MODES}, got {coins!r}")
    return "philox16" if coins in _FUSED_COINS else coins


def fold_seed(seed: int, data: int) -> int:
    """A new seed in [0, 2^63) from ``seed`` and an integer (the counterpart
    of ``jax.random.fold_in``): one splitmix64 round."""
    z = (seed + 0x9E3779B97F4A7C15 * (data + 1)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & MAX_SEED


def _check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed <= MAX_SEED:
        raise ValueError(f"seed must lie in [0, 2^63), got {seed}")
    return seed


def _resolve_matmul(matmul: str, device: torch.device) -> str:
    if matmul not in _MATMULS:
        raise ValueError(f"matmul must be one of {_MATMULS}, got {matmul!r}")
    if device.type != "cuda":
        return "f32"
    return CUDA_AUTO_MATMUL if matmul == "auto" else matmul


# Device-resident adjacency cache: the dense adjacency of a large graph is
# gigabytes, built once per (graph, type, device) and dropped with the graph.
_ADJ_CACHE: dict = {}


def device_adjacency(graph: Graph, route: str, device: torch.device) -> torch.Tensor:
    """The dense {0,1} adjacency for the count product, built on ``device``
    from the edge list. The int8 operand is zero-padded to a multiple of 8
    nodes, which ``torch._int_mm`` requires."""
    key = (id(graph), route, str(device))
    hit = _ADJ_CACHE.get(key)
    if hit is not None:
        return hit
    n = graph.n_nodes
    dtype = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}[route]
    side = -(-n // 8) * 8 if route == "int8" else n
    a = torch.zeros((side, side), dtype=dtype, device=device)
    dst = torch.as_tensor(graph.dst, dtype=torch.long, device=device)
    src = torch.as_tensor(graph.src, dtype=torch.long, device=device)
    if route == "int8":
        a[src, dst] = 1
        a = a.t()  # column-major in memory, the layout cuBLASLt's int8 product takes
    else:
        a[dst, src] = 1
    _ADJ_CACHE[key] = a
    weakref.finalize(graph, _ADJ_CACHE.pop, key, None)
    return a


def count_product(i: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Infected-neighbour counts ``i @ a``, exact: int32 from an int8 ``a``,
    float32 from a bf16 or f32 ``a``. ``i``: [rows, n] int8 indicators."""
    rows, n = i.shape
    if a.dtype == torch.int8:
        # torch._int_mm wants more than 16 rows and inner/outer sizes that
        # are multiples of 8
        pad_rows, pad_cols = max(0, 17 - rows), a.shape[0] - n
        x = torch.nn.functional.pad(i, (0, pad_cols, 0, pad_rows)) if pad_rows or pad_cols else i
        counts = torch._int_mm(x, a)
        return counts[:rows, :n].contiguous() if pad_rows or pad_cols else counts
    if a.dtype == torch.bfloat16:
        return torch.mm(i.to(torch.bfloat16), a, out_dtype=torch.float32)
    return i.to(torch.float32) @ a


def auto_trials_chunk(n: int, sims: int, device: torch.device) -> int:
    """Trials per dispatch, from the memory this process can take on
    ``device`` now: half of what ``torch.cuda.mem_get_info`` reports free
    plus what PyTorch's allocator holds unused (2 GB on the CPU). Per trial:
    the int8 (I, R) state before and after a step, the 4-byte counts and a
    2-byte copy of I as the product's operand."""
    per_trial = sims * n * (2 + 2 + 4 + 2)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        held = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        budget = (free + held) // 2
    else:
        budget = 2_000_000_000
    return max(1, min(32, int(budget // max(per_trial, 1))))


def balanced_chunk(n_items: int, cap: int) -> int:
    """The chunk size that splits ``n_items`` into the fewest chunks of at
    most ``cap`` and balances them (16 items at cap 13 run as 8 + 8)."""
    return -(-n_items // -(-n_items // cap))


def _plain_coin_step(i, r, counts, log1m_beta, gamma, sims, coins, generators):
    """The 'bits32' and 'uniform' coin modes: plain torch ops, one
    generator per trial."""
    n = i.shape[1]
    rows = lambda t: t.repeat_interleave(sims)[:, None]
    p_inf = -torch.expm1(counts.to(torch.float32) * rows(log1m_beta))
    g_rows = rows(gamma)
    if coins == "bits32":
        draw = lambda g: torch.randint(0, 2**32, (sims, n), generator=g, device=i.device,
                                       dtype=torch.int64).to(torch.float32)
        p_inf, g_rows = p_inf * 4294967296.0, g_rows * 4294967296.0
    else:
        draw = lambda g: torch.rand((sims, n), generator=g, device=i.device)
    u = torch.cat([draw(g) for g in generators])
    v = torch.cat([draw(g) for g in generators])
    s = 1 - i - r
    new_inf = s * (u < p_inf).to(i.dtype)
    new_rec = i * (v < g_rows).to(i.dtype)
    return i + new_inf - new_rec, r + new_rec


class _Stepper:
    """The per-dispatch state of a batch of trials: rates, seeds and the
    adjacency on one device; :meth:`step` advances [trials * sims, n]."""

    def __init__(self, a, betas, gammas, seeds, sims, coins):
        device = a.device
        self.a, self.sims = a, sims
        self.coins = _resolve_coins(coins)
        # rates are rounded to f32 on the host, so a card and the CPU compare
        # every coin with the same thresholds
        beta32 = torch.as_tensor(np.asarray(betas, np.float32))
        gamma32 = torch.as_tensor(np.asarray(gammas, np.float32))
        self.log1m_beta = torch.log1p(-beta32).to(device)
        self.gamma = gamma32.to(device)
        self.gamma16 = (gamma32 * 65536.0).to(device)
        seeds = [_check_seed(s) for s in seeds]
        self.seeds = torch.as_tensor(seeds, dtype=torch.int64, device=device)
        self.generators = None
        if self.coins != "philox16":
            self.generators = [torch.Generator(device=device).manual_seed(s) for s in seeds]

    def init_state(self, masks: np.ndarray):
        """[trials, n] seed masks -> int8 (I, R), each [trials * sims, n]."""
        trials, n = masks.shape
        m = torch.as_tensor(masks.astype(np.int8), device=self.a.device)
        i = m[:, None, :].expand(trials, self.sims, n).reshape(trials * self.sims, n)
        return i.contiguous(), torch.zeros_like(i)

    def step(self, i, r, t: int):
        counts = count_product(i, self.a)
        if self.coins == "philox16":
            return sir_step(i, r, counts, self.log1m_beta, self.gamma16, self.seeds, t,
                            sims=self.sims)
        return _plain_coin_step(i, r, counts, self.log1m_beta, self.gamma, self.sims,
                                self.coins, self.generators)


def _simulate_trials(a, masks, betas, gammas, seeds, *, sims: int, max_time: int,
                     coins: str) -> np.ndarray:
    """B trials in one dispatch -> (I, R) indicator SUMS [B, T, 2, n] f32 on
    the host. Sums of 0/1 indicators are exact in f32 below 2^24. Under a
    profiler its spans ``labels.prepare``, ``labels.steps`` (the time loop's
    enqueue) and ``labels.readback``."""
    trials, n = masks.shape
    with span("labels.prepare"):
        stepper = _Stepper(a, betas, gammas, seeds, sims, coins)
        i, r = stepper.init_state(masks)
        sums = torch.empty((max_time, 2, trials, n), dtype=torch.float32, device=a.device)
    with span("labels.steps"):
        ssum = lambda x: x.view(trials, sims, n).sum(1, dtype=torch.float32)
        sums[0, 0], sums[0, 1] = ssum(i), ssum(r)
        for t in range(1, max_time):
            i, r = stepper.step(i, r, t)
            sums[t, 0], sums[t, 1] = ssum(i), ssum(r)
    with span("labels.readback"):
        return sums.permute(2, 0, 1, 3).cpu().numpy()


def _expand_ir_sums(ir_sums, sims: int) -> np.ndarray:
    """[T, 2, n] (I, R) sums -> [T, 3, n] f32 (S, I, R) sums on the host."""
    arr = np.asarray(ir_sums, dtype=np.float32)
    s = np.float32(sims) - arr[:, 0] - arr[:, 1]
    return np.stack([s, arr[:, 0], arr[:, 1]], axis=1)


def _seeds_mask(n_nodes: int, seed_nodes) -> np.ndarray:
    mask = np.zeros(n_nodes, np.float32)
    mask[np.asarray(seed_nodes)] = 1.0
    return mask


def _sims_chunks(sims: int, sims_chunk: int | None, seed: int):
    """(chunk size, chunk seed) pairs. One chunk runs under ``seed`` itself;
    several run under ``fold_seed(seed, 1000 + chunk)``, in equal sizes where
    ``sims`` divides — the schedule the counts and per-sim paths share."""
    if sims_chunk is None or sims_chunk >= sims:
        return [(sims, seed)]
    n_chunks = -(-sims // sims_chunk)
    if sims % n_chunks == 0:
        sims_chunk = sims // n_chunks
    out, done = [], 0
    while done < sims:
        c = min(sims_chunk, sims - done)
        out.append((c, fold_seed(seed, 1000 + len(out))))
        done += c
    return out


def simulate_sir_counts(
    graph: Graph,
    seed_nodes,
    beta: float,
    gamma: float,
    *,
    sims: int = 10000,
    max_time: int = 20,
    seed: int = 0,
    sims_chunk: int | None = None,
    coins: str = "auto",
    matmul: str = "auto",
    device,
):
    """Indicator-count sums [max_time, 3, n] (host f32) over ``sims``
    trajectories. ``sims_chunk`` bounds the [sims, n] working set; chunks run
    one after another, each fully vectorized."""
    device = torch.device(device)
    seed = _check_seed(seed)
    a = device_adjacency(graph, _resolve_matmul(matmul, device), device)
    mask = _seeds_mask(graph.n_nodes, seed_nodes)[None]
    total = None
    for c, chunk_seed in _sims_chunks(sims, sims_chunk, seed):
        ir = _simulate_trials(a, mask, [beta], [gamma], [chunk_seed], sims=c,
                              max_time=max_time, coins=coins)[0]
        total = ir if total is None else total + ir
    return _expand_ir_sums(total, sims)


def simulate_sir_counts_many(
    graph: Graph,
    trials,
    *,
    sims: int = 10000,
    max_time: int = 20,
    seeds=None,
    trials_chunk: int | None = None,
    coins: str = "auto",
    matmul: str = "auto",
    device,
):
    """Indicator-count sums for MANY trials of one graph: a list of
    [max_time, 3, n] f32 arrays, one per ``(seed_nodes, beta, gamma)`` in
    ``trials``. ``trials_chunk`` trials advance in one dispatch (one count
    product and one K2 launch per step for all of them); it defaults to what
    the device's free memory holds, balanced over the chunks.

    ``seeds``: one integer per trial (default ``fold_seed(0, 1000 + j)``).
    Each trial's result equals :func:`simulate_sir_counts` under its seed.
    """
    device = torch.device(device)
    n, ntr = graph.n_nodes, len(trials)
    if seeds is None:
        seeds = [fold_seed(0, 1000 + j) for j in range(ntr)]
    if len(seeds) != ntr:
        raise ValueError(f"{len(seeds)} seeds for {ntr} trials")
    _resolve_coins(coins)
    if ntr == 0:
        return []
    a = device_adjacency(graph, _resolve_matmul(matmul, device), device)
    if trials_chunk is None:
        trials_chunk = balanced_chunk(ntr, auto_trials_chunk(n, sims, device))
    masks = np.stack([_seeds_mask(n, sn) for sn, _, _ in trials])
    betas = [b for _, b, _ in trials]
    gammas = [g for _, _, g in trials]
    out: list[np.ndarray] = []
    for lo in range(0, ntr, max(1, trials_chunk)):
        sl = slice(lo, lo + max(1, trials_chunk))
        ir = _simulate_trials(a, masks[sl], betas[sl], gammas[sl], seeds[sl], sims=sims,
                              max_time=max_time, coins=coins)
        with span("labels.unpack"):
            out.extend(_expand_ir_sums(row, sims) for row in ir)
    return out


def _to_probs(sums, sims: int):
    probs = np.asarray(sums, dtype=np.float64) / float(sims)
    return probs[:, 0, :], probs[:, 1, :], probs[:, 2, :]


def simulate_sir_many(graph: Graph, trials, *, sims: int = 10000, max_time: int = 20,
                      seeds=None, trials_chunk: int | None = None, coins: str = "auto",
                      matmul: str = "auto", device):
    """Batched label triples: a list of per-node (S, I, R) probability arrays
    (each [max_time, n] float64), one per trial. See
    :func:`simulate_sir_counts_many`. Under a profiler the host's float64
    division after the last chunk is the span ``labels.probs``."""
    sums = simulate_sir_counts_many(
        graph, trials, sims=sims, max_time=max_time, seeds=seeds,
        trials_chunk=trials_chunk, coins=coins, matmul=matmul, device=device)
    with span("labels.probs"):
        return [_to_probs(arr, sims) for arr in sums]


def simulate_sir(graph: Graph, seed_nodes, beta: float, gamma: float, *,
                 sims: int = 10000, max_time: int = 20, seed: int = 0,
                 sims_chunk: int | None = None, coins: str = "auto",
                 matmul: str = "auto", device):
    """Per-node S/I/R probabilities, each [max_time, n] float64 (the label
    triple)."""
    sums = simulate_sir_counts(
        graph, seed_nodes, beta, gamma, sims=sims, max_time=max_time, seed=seed,
        sims_chunk=sims_chunk, coins=coins, matmul=matmul, device=device)
    return _to_probs(sums, sims)


def simulate_sir_per_sim(graph: Graph, seed_nodes, beta: float, gamma: float, *,
                         sims: int = 1000, max_time: int = 20, seed: int = 0,
                         sims_chunk: int | None = None, coins: str = "auto",
                         matmul: str = "auto", device):
    """Per-simulation indicator trajectories (S, I, R), each [sims, T, n]
    uint8, for variance and quantile analyses over simulations (see
    :func:`sir_per_sim_stats`). Chunks draw the same per-chunk streams as the
    chunked counts path, so a chunked per-sim run sums to the chunked counts
    run. The host tensor is sims * T * n bytes per channel."""
    device = torch.device(device)
    seed = _check_seed(seed)
    a = device_adjacency(graph, _resolve_matmul(matmul, device), device)
    mask = _seeds_mask(graph.n_nodes, seed_nodes)[None]
    parts = []
    for c, chunk_seed in _sims_chunks(sims, sims_chunk, seed):
        stepper = _Stepper(a, [beta], [gamma], [chunk_seed], c, coins)
        i, r = stepper.init_state(mask)
        states = [torch.stack([1 - i - r, i, r])]
        for t in range(1, max_time):
            i, r = stepper.step(i, r, t)
            states.append(torch.stack([1 - i - r, i, r]))
        # [T, 3, c, n] -> [3, c, T, n]
        parts.append(torch.stack(states).to(torch.uint8).permute(1, 2, 0, 3).cpu().numpy())
    s, i, r = np.concatenate(parts, axis=1)
    return s, i, r


def sir_per_sim_stats(s, i, r):
    """Across-simulation statistics from per-sim indicator tensors:
    ``{"mean": [3, T, n], "std": [3, T, n]}``, axis 0 being (S, I, R).
    Indicators satisfy x^2 == x, so the standard deviation follows from the
    mean, sqrt(p (1 - p)), with no second pass over [sims, T, n]."""
    mean = np.stack([np.mean(np.asarray(x), axis=0, dtype=np.float64)
                     for x in (s, i, r)])
    return {"mean": mean, "std": np.sqrt(mean * (1.0 - mean))}
