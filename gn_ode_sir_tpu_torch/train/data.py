"""Trial dataset assembly, splits, and static-shape batching (port of
``gn_ode_sir_tpu.train.data``; numpy only, and kept line for line so that
``default_rng`` draws the same batch orders and splits in both packages).

Replaces the reference's inline tensor assembly + TensorDataset/DataLoader
(C17/C18, ``ode_nn_ngraph_sim.py:358-429``). A trial is (seed set, beta,
gamma) with its [T, n, 3] MC label tensor; the dataset is a struct of
arrays over trials. Splits reproduce the reference semantics exactly:
order-based 60/20/20 with int-floor boundaries (``:385-397``) and the
out-of-distribution gamma-binned index dict (``:399-414``).
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrialData:
    """Struct-of-arrays over N trials on graphs with n nodes (padded)."""

    s0: np.ndarray  # [N, n]
    i0: np.ndarray  # [N, n]
    r0: np.ndarray  # [N, n]
    beta: np.ndarray  # [N]
    gamma: np.ndarray  # [N]
    labels: np.ndarray  # [N, T, n, 3]
    graph_idx: np.ndarray  # [N] int32 (all zeros for single-graph runs)

    @property
    def num_trials(self) -> int:
        return int(self.beta.shape[0])

    def take(self, idx) -> "TrialData":
        idx = np.asarray(idx)
        return TrialData(
            self.s0[idx], self.i0[idx], self.r0[idx],
            self.beta[idx], self.gamma[idx], self.labels[idx], self.graph_idx[idx],
        )


def build_trial_data(
    n_nodes: int,
    seed_sets,
    betas,
    gammas,
    label_triples,
    graph_idx=None,
    n_pad: int | None = None,
) -> TrialData:
    """Assemble trials. ``label_triples[i]`` is (S, I, R), each [T, n_i].

    For multi-graph datasets pass ``n_pad`` >= max graph size; per-trial
    node arrays are zero-padded to it (mask by graph separately).
    """
    N = len(seed_sets)
    n = n_pad or n_nodes
    T = label_triples[0][0].shape[0]
    s0 = np.zeros((N, n), np.float32)
    i0 = np.zeros((N, n), np.float32)
    r0 = np.zeros((N, n), np.float32)
    labels = np.zeros((N, T, n, 3), np.float32)
    for k in range(N):
        S, I, R = label_triples[k]
        ni = S.shape[1]
        i0[k, np.asarray(list(seed_sets[k]), dtype=np.int64)] = 1.0
        s0[k, :ni] = 1.0 - i0[k, :ni]
        labels[k, :, :ni, 0] = S
        labels[k, :, :ni, 1] = I
        labels[k, :, :ni, 2] = R
    gi = np.zeros(N, np.int32) if graph_idx is None else np.asarray(graph_idx, np.int32)
    return TrialData(
        s0, i0, r0,
        np.asarray(betas, np.float32), np.asarray(gammas, np.float32),
        labels, gi,
    )


def split_indices(n_trials: int, ratios=(0.6, 0.2, 0.2)):
    """Order-based split with the reference's int-floor boundary arithmetic
    (``ode_nn_ngraph_sim.py:389-396``)."""
    b1 = int(ratios[0] * n_trials)
    b2 = int((ratios[0] + ratios[1]) * n_trials)
    idx = np.arange(n_trials)
    return idx[:b1], idx[b1:b2], idx[b2:]


def make_out_of_dist_split(
    gammas,
    n_bins: int = 4,
    n_train: int | None = None,
    n_val: int | None = None,
    seed: int = 0,
):
    """Generate a gamma-binned out-of-distribution split dict.

    Reverse-engineered from the shipped ``out-of-dist-gamma.pkl`` fixture
    (verified on Experiments-seed2-karate): a ``n_bins``-bin histogram over
    the trial gammas; TRAIN draws only from the middle bins (in-distribution
    range), while val/test absorb the extreme bins plus the leftover middle
    trials — so test mostly probes gammas the model never saw.
    Schema matches the fixture: keys train/val/test/test-in-dist/counts/bins.
    """
    gammas = np.asarray(gammas)
    n = len(gammas)
    counts, bins = np.histogram(gammas, bins=n_bins)
    lo, hi = bins[1], bins[n_bins - 1]  # middle-bin range
    in_dist = np.where((gammas >= lo) & (gammas < hi))[0]
    out_dist = np.setdiff1d(np.arange(n), in_dist)

    rng = np.random.default_rng(seed)
    n_train = n_train if n_train is not None else int(0.4 * n)
    n_val = n_val if n_val is not None else int(0.2 * n)
    in_dist = rng.permutation(in_dist)
    train = in_dist[:n_train]
    rest = rng.permutation(np.concatenate([in_dist[n_train:], out_dist]))
    val = rest[:n_val]
    test = rest[n_val:]
    return {
        "train": set(int(i) for i in train),
        "val": set(int(i) for i in val),
        "test": set(int(i) for i in test),
        "test-in-dist": set(int(i) for i in test if lo <= gammas[i] < hi),
        "counts": counts,
        "bins": bins,
    }


def out_of_dist_split(path: str):
    """Load the gamma-binned out-of-distribution split dict
    (``out-of-dist-gamma.pkl``: keys train/val/test/..., ``ode_nn_ngraph_sim.py:400``).

    Membership semantics mirror the reference: a trial not in 'train' and
    not in 'val' goes to test (``:406-414``)."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    train = np.asarray(sorted(d["train"]), np.int64)
    val = np.asarray(sorted(d["val"]), np.int64)
    in_train = set(int(i) for i in train)
    in_val = set(int(i) for i in val)
    return {"train": train, "val": val, "dict": d,
            "in_train": in_train, "in_val": in_val}


def epoch_batches_grouped(idx, graph_ids, batch_size: int,
                          rng: np.random.Generator | None):
    """Graph-HOMOGENEOUS batches of absolute trial indices.

    Like :func:`epoch_batches` but every batch contains trials of a single
    graph (each group's partial batch pads by repeating a trial of the SAME
    graph with weight 0), so per-batch connectivity is one shared plan and
    the SpMM kernel serves the whole batch in one launch
    (``Spmm2Adj.matvec``). Group sizes are fixed by the split, so the
    [n_batches, batch_size] shape is identical every epoch; with ``rng``,
    trials shuffle within groups and batch order shuffles across groups. Deviation from the reference's cross-graph
    DataLoader shuffle (``ode_nn_ngraphs.py:179-196``): documented D15.
    """
    idx = np.asarray(idx)
    if idx.size == 0:
        # mirror epoch_batches(0, ...): an empty split yields zero batches,
        # not a np.concatenate([]) ValueError (fit() calls this
        # unconditionally for val/test splits that may be empty)
        return (np.zeros((0, batch_size), np.int32),
                np.zeros((0, batch_size), np.float32))
    gids = np.asarray(graph_ids)[idx]
    rows, ws = [], []
    for g in np.unique(gids):
        gidx = idx[gids == g]
        if rng is not None:
            gidx = rng.permutation(gidx)
        nb = -(-len(gidx) // batch_size)
        pad = nb * batch_size - len(gidx)
        w = np.ones(nb * batch_size, np.float32)
        if pad:
            gidx = np.concatenate([gidx, np.full(pad, gidx[0], gidx.dtype)])
            w[-pad:] = 0.0
        rows.append(gidx.reshape(nb, batch_size))
        ws.append(w.reshape(nb, batch_size))
    rows = np.concatenate(rows)
    ws = np.concatenate(ws)
    if rng is not None:
        order = rng.permutation(rows.shape[0])
        rows, ws = rows[order], ws[order]
    return rows.astype(np.int32), ws


def epoch_batches(n: int, batch_size: int, rng: np.random.Generator | None):
    """Batch index matrix [n_batches, batch_size] + weights [n_batches, bs].

    Shuffled when ``rng`` given (training); the final partial batch is padded
    by repeating index 0 with weight 0 so every step has a static shape.
    """
    idx = rng.permutation(n) if rng is not None else np.arange(n)
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    w = np.ones(n_batches * batch_size, np.float32)
    if pad:
        idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
        w[-pad:] = 0.0
    return (
        idx.reshape(n_batches, batch_size).astype(np.int32),
        w.reshape(n_batches, batch_size),
    )
