"""Port parity: train/loss.py (1e-6) and train/data.py (exactly) against the
JAX package. ``train/data.py`` is numpy only and must draw the same batch
orders and splits from ``default_rng`` as the JAX package's."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.train import data as jdata
from gn_ode_sir_tpu.train import loss as jloss
from gn_ode_sir_tpu_torch.train import data as tdata
from gn_ode_sir_tpu_torch.train import loss as tloss

torch.set_num_threads(1)

ATOL = 1e-6


def _loss_inputs(seed=0, T=5, B=3, n=7):
    rng = np.random.default_rng(seed)
    pred = rng.random((T, B, n, 3)).astype(np.float32)
    labels = rng.random((B, T, n, 3)).astype(np.float32)
    tw = np.array([1.0, 1.0, 0.0], np.float32)
    nm = (rng.random((B, n)) < 0.7).astype(np.float32)
    return pred, labels, tw, nm


@pytest.mark.parametrize("use_tw", [False, True])
@pytest.mark.parametrize("use_nm", [False, True])
def test_l1_sir_loss_matches_jax(use_tw, use_nm):
    pred, labels, tw, nm = _loss_inputs()
    kw_j = dict(trial_weight=jnp.asarray(tw) if use_tw else None,
                node_mask=jnp.asarray(nm) if use_nm else None)
    kw_t = dict(trial_weight=torch.as_tensor(tw) if use_tw else None,
                node_mask=torch.as_tensor(nm) if use_nm else None)
    want = jloss.l1_sir_loss(jnp.asarray(pred), jnp.asarray(labels), **kw_j)
    got = tloss.l1_sir_loss(torch.as_tensor(pred), torch.as_tensor(labels), **kw_t)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    jn, jd = jloss.l1_sir_loss_sums(jnp.asarray(pred), jnp.asarray(labels), **kw_j)
    tn, td = tloss.l1_sir_loss_sums(torch.as_tensor(pred), torch.as_tensor(labels), **kw_t)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


def test_loss_ignores_t0_and_zero_weight_guard():
    pred, labels, tw, _ = _loss_inputs(1)
    base = tloss.l1_sir_loss(torch.as_tensor(pred), torch.as_tensor(labels))
    pred2 = pred.copy()
    pred2[0] += 5.0  # t = 0 is not scored
    assert tloss.l1_sir_loss(torch.as_tensor(pred2), torch.as_tensor(labels)) == base
    zero = tloss.l1_sir_loss(torch.as_tensor(pred), torch.as_tensor(labels),
                             trial_weight=torch.zeros(3))
    assert float(zero) == 0.0  # the 1e-12 guard, not a 0/0


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_l1_matches_jax(weighted):
    rng = np.random.default_rng(2)
    a, b = rng.random((4, 6, 3)).astype(np.float32), rng.random((4, 6, 3)).astype(np.float32)
    w = rng.random((4, 6, 1)).astype(np.float32) if weighted else None
    want = jloss.masked_l1(jnp.asarray(a), jnp.asarray(b), None if w is None else jnp.asarray(w))
    got = tloss.masked_l1(torch.as_tensor(a), torch.as_tensor(b),
                          None if w is None else torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n,bs", [(10, 3), (8, 4), (5, 8), (0, 2)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_batches_equal(n, bs, shuffle):
    mk = lambda: np.random.default_rng(3) if shuffle else None
    (ji, jw), (ti, tw) = jdata.epoch_batches(n, bs, mk()), tdata.epoch_batches(n, bs, mk())
    assert ti.dtype == np.int32 and tw.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_batches_grouped_equal(shuffle):
    gids = np.array([0, 0, 1, 1, 1, 2, 0, 2, 2, 2, 1])
    idx = np.array([0, 2, 3, 4, 5, 6, 8, 9, 10])
    mk = lambda: np.random.default_rng(4) if shuffle else None
    ji, jw = jdata.epoch_batches_grouped(idx, gids, 2, mk())
    ti, tw = tdata.epoch_batches_grouped(idx, gids, 2, mk())
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)
    for row in ti:
        assert len(set(gids[row])) == 1  # graph-homogeneous
    ei, ew = tdata.epoch_batches_grouped(np.zeros(0, np.int64), gids, 2, None)
    assert ei.shape == (0, 2) and ew.shape == (0, 2)


@pytest.mark.parametrize("n_pad", [None, 12])
def test_build_trial_data_equal(n_pad):
    rng = np.random.default_rng(5)
    n, T, N = 9, 4, 5
    nodes = [[1, 2], [0], [8, 3], [4], [5, 6]]
    beta, gamma = rng.random(N), rng.random(N)
    triples = [tuple(rng.random((T, n)) for _ in range(3)) for _ in range(N)]
    jd = jdata.build_trial_data(n, nodes, beta, gamma, triples, graph_idx=[0, 1, 0, 1, 0],
                                n_pad=n_pad)
    td = tdata.build_trial_data(n, nodes, beta, gamma, triples, graph_idx=[0, 1, 0, 1, 0],
                                n_pad=n_pad)
    for f in ("s0", "i0", "r0", "beta", "gamma", "labels", "graph_idx"):
        a, b = getattr(td, f), getattr(jd, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert td.num_trials == N
    np.testing.assert_array_equal(td.take([3, 1]).labels, jd.take([3, 1]).labels)


@pytest.mark.parametrize("n,ratios", [(10, (0.6, 0.2, 0.2)), (7, (0.5, 0.25, 0.25)),
                                      (6, (0.6, 0.2, 0.2)), (200, (0.4, 0.2, 0.4))])
def test_split_indices_equal(n, ratios):
    for a, b in zip(tdata.split_indices(n, ratios), jdata.split_indices(n, ratios)):
        np.testing.assert_array_equal(a, b)


def test_out_of_dist_splits_equal(tmp_path):
    gammas = np.random.default_rng(6).uniform(0.05, 0.5, 40)
    jd = jdata.make_out_of_dist_split(gammas, seed=2)
    td = tdata.make_out_of_dist_split(gammas, seed=2)
    assert set(td) == set(jd)
    for k in ("train", "val", "test", "test-in-dist"):
        assert td[k] == jd[k]
    np.testing.assert_array_equal(td["counts"], jd["counts"])
    np.testing.assert_array_equal(td["bins"], jd["bins"])
    assert td["train"] and not (td["train"] & td["test"])
    path = tmp_path / "out-of-dist-gamma.pkl"
    with open(path, "wb") as f:
        pickle.dump(jd, f)
    lt, lj = tdata.out_of_dist_split(str(path)), jdata.out_of_dist_split(str(path))
    np.testing.assert_array_equal(lt["train"], lj["train"])
    np.testing.assert_array_equal(lt["val"], lj["val"])
    assert lt["in_train"] == lj["in_train"] and lt["in_val"] == lj["in_val"]
