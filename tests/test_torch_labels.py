"""Port parity: the label cache (gn_ode_sir_tpu_torch.utils.labels) against
the JAX package's. Same file names and float64 pickles, so a cache written
by either package loads in the other, count-valued pickles included."""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.utils import labels as jax_labels
from gn_ode_sir_tpu_torch.graphs.graph import Graph
from gn_ode_sir_tpu_torch.sim.fused_step import sir_step

from gn_ode_sir_tpu_torch.utils import (
    label_paths,
    load_labels,
    load_or_extract_labels,
    load_or_extract_labels_many,
)

torch.set_num_threads(1)

TRIALS = [([2, 5], 0.3, 0.1), ([7], 0.25, 0.4), ([2, 5], 0.123456789, 0.2)]


def _port_graph(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


@pytest.mark.parametrize("rates", [(None, None), (0.3, 0.1), (0.123456789, 1 / 3)])
def test_label_paths_equal_the_jax_names(rates):
    got = label_paths("/d", "karate", [25, 18], *rates)
    assert got == jax_labels.label_paths("/d", "karate", [25, 18], *rates)
    assert set(got) == {"S", "I", "R"}


def test_cache_written_by_the_port_loads_in_jax(karate, tmp_path):
    d = str(tmp_path)
    g = _port_graph(karate)
    fresh = load_or_extract_labels_many(g, TRIALS, sim=300, max_time=6, save_dir=d,
                                        seeds=[1, 2, 3], device="cpu")
    for (nodes, beta, gamma), triple in zip(TRIALS, fresh):
        got = jax_labels.load_labels(d, "karate", nodes, 300, beta, gamma)
        assert got is not None
        for a, b in zip(got, triple):
            assert a.dtype == np.float64 and a.shape == (6, karate.n_nodes)
            np.testing.assert_array_equal(a, b)
    # the JAX package now finds every trial cached: it simulates nothing
    again = jax_labels.load_or_extract_labels_many(
        karate, TRIALS, sim=300, max_time=6, save_dir=d,
        keys=[jax.random.PRNGKey(k) for k in range(3)])
    np.testing.assert_array_equal(again[2][1], fresh[2][1])
    with open(os.path.join(d, "coins-mode.json")) as f:
        assert json.load(f)["coins"] == "philox16"


def test_cache_written_by_jax_loads_in_the_port(karate, tmp_path):
    d = str(tmp_path)
    fresh = jax_labels.load_or_extract_labels_many(
        karate, TRIALS[:2], sim=300, max_time=6, save_dir=d,
        keys=[jax.random.PRNGKey(k) for k in range(2)])
    before = sir_step.launches
    got = load_or_extract_labels_many(_port_graph(karate), TRIALS[:2], sim=300, max_time=6,
                                      save_dir=d, device="cpu")
    assert sir_step.launches == before
    for a, b in zip(got, fresh):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    one = load_or_extract_labels(_port_graph(karate), *TRIALS[0], sim=300, max_time=6,
                                 save_dir=d, device="cpu")
    np.testing.assert_array_equal(one[0], fresh[0][0])


def test_count_valued_pickles_are_divided_by_sim(tmp_path):
    """Seeds-only legacy names holding raw counts (the wiki-vote / enron
    convention) load as probabilities in both packages."""
    d = str(tmp_path)
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 1000, size=(3, 5, 9)).astype(np.float64)
    counts[0, 0, 0] = 1000.0
    for c, arr in zip("SIR", counts):
        with open(label_paths(d, "g", [4, 1])[c], "wb") as f:
            pickle.dump(arr, f)
    got = load_labels(d, "g", [4, 1], sim=1000, beta=0.2, gamma=0.1)  # falls back
    want = jax_labels.load_labels(d, "g", [4, 1], sim=1000, beta=0.2, gamma=0.1)
    for a, b, c in zip(got, want, counts):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c / 1000.0)
    with pytest.raises(ValueError, match="sim not given"):
        load_labels(d, "g", [4, 1])
    assert load_labels(d, "g", [4, 2], sim=1000) is None


def test_second_call_is_a_pure_cache_hit_and_misses_are_filled(karate, tmp_path, capsys):
    d = str(tmp_path)
    g = _port_graph(karate)
    kw = dict(sim=200, max_time=5, save_dir=d, device="cpu")
    first = load_or_extract_labels_many(g, TRIALS[:2], seeds=[1, 2], **kw)
    mtimes = {f: os.path.getmtime(os.path.join(d, f)) for f in os.listdir(d)}
    both = load_or_extract_labels_many(g, TRIALS, seeds=[1, 2, 3], **kw)
    np.testing.assert_array_equal(both[0][1], first[0][1])
    assert all(os.path.getmtime(os.path.join(d, f)) == t for f, t in mtimes.items())
    assert len([f for f in os.listdir(d) if f.endswith(".pkl")]) == 9
    # the miss was simulated under ITS seed, as the one-trial path would
    alone = load_or_extract_labels(g, *TRIALS[2], sim=200, max_time=5, seed=3, device="cpu")
    np.testing.assert_array_equal(both[2][1], alone[1])
    # the sims_chunk regime runs per trial, and another coin mode is flagged
    chunked = load_or_extract_labels_many(g, [([9], 0.2, 0.2)], seeds=[4], sims_chunk=100,
                                          coins="uniform", **kw)
    np.testing.assert_allclose(sum(chunked[0]), 1.0, atol=1e-12)
    assert "WARNING" in capsys.readouterr().out
    # no save_dir: nothing is written, labels still come back
    n_files = len(os.listdir(d))
    free = load_or_extract_labels_many(g, TRIALS[:1], sim=50, max_time=3, device="cpu")
    assert free[0][0].shape == (3, g.n_nodes) and len(os.listdir(d)) == n_files
