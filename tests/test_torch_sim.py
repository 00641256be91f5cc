"""Port parity: the Monte-Carlo SIR simulator (gn_ode_sir_tpu_torch.sim) and
the plain version of K2 against the JAX package.

The two packages draw different random streams (Philox4x32-10 here,
threefry there), so: the generator is held to Random123's known answers; a
single step is compared with the SAME words fed to both sides; and label
means are compared within 5 binomial standard errors. On the CPU ``sir_step``
runs its plain version; the kernel is held against it on the card in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.sim import simulate_sir as jax_simulate_sir
from gn_ode_sir_tpu.sim.mc_sir import _sir_transition as jax_sir_transition
from gn_ode_sir_tpu_torch.graphs.graph import Graph, graph_from_edges
from gn_ode_sir_tpu_torch.sim import (
    simulate_sir,
    simulate_sir_counts,
    simulate_sir_counts_many,
    simulate_sir_many,
    simulate_sir_per_sim,
    sir_per_sim_stats,
)
from gn_ode_sir_tpu_torch.sim import mc_sir
from gn_ode_sir_tpu_torch.sim.fused_step import (
    philox4x32,
    philox4x32_words,
    sir_step,
    sir_update_plain,
)

torch.set_num_threads(1)


def _port_graph(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox4x32_10_known_answers(counter, key, want):
    """Random123's known-answer vectors for philox4x32-10."""
    t = lambda vals: [torch.tensor([v], dtype=torch.int64) for v in vals]
    got = " ".join(f"{int(w):08x}" for w in philox4x32(t(counter), t(key)))
    assert got == want


@pytest.mark.parametrize("numel", [1, 4, 7, 64])
def test_philox_words_layout(numel):
    """Element e takes word e % 4 of Philox(counter=(e // 4, step), key=seed),
    whatever the length asked for; the seed's two halves are the key."""
    seed, step = (0x299F31D0 << 32) | 0xA4093822, 9
    words = philox4x32_words(seed, step, numel, device="cpu")
    assert words.shape == (numel,) and words.dtype == torch.int64
    assert int(words.min()) >= 0 and int(words.max()) < 2**32
    for e in range(numel):
        t = lambda v: torch.tensor([v], dtype=torch.int64)
        ref = philox4x32((t(e // 4), t(0), t(step), t(0)),
                         (t(seed & 0xFFFFFFFF), t(seed >> 32)))
        assert int(words[e]) == int(ref[e % 4])
    longer = philox4x32_words(seed, step, numel + 5, device="cpu")
    assert torch.equal(longer[:numel], words)
    assert not torch.equal(philox4x32_words(seed, step + 1, numel, device="cpu"), words)


@pytest.mark.parametrize("state_dtype", ["int8", "float32"])
def test_single_step_matches_jax_bits16(karate, state_dtype):
    """The same (I, R), adjacency and uint32 words through the JAX ``bits16``
    transition and ``sir_update_plain``: equal, except where the low
    half-word lies within 1 of the threshold p_inf * 2^16 (expm1 may differ
    in its last bit between the two frameworks); such elements stay under
    0.1%."""
    n, sims, t = karate.n_nodes, 512, 3
    rng = np.random.default_rng(0)
    i = (rng.random((sims, n)) < 0.25).astype(np.float32)
    r = ((rng.random((sims, n)) < 0.2) & (i == 0)).astype(np.float32)
    beta, gamma = np.float32(0.3), np.float32(0.15)
    key = jax.random.PRNGKey(7)
    a = jnp.asarray(karate.dense_adjacency, jnp.bfloat16)
    log1m_beta = jnp.log1p(-beta)
    ji, jr = jax_sir_transition(jnp.asarray(i), jnp.asarray(r), a, log1m_beta,
                                jnp.float32(gamma), key, t, "bits16")
    words = np.asarray(jax.random.bits(jax.random.fold_in(key, t), (sims, n), jnp.uint32))

    dt = getattr(torch, state_dtype)
    ti, tr = torch.as_tensor(i).to(dt), torch.as_tensor(r).to(dt)
    counts = mc_sir.count_product(ti.to(torch.int8),
                                  torch.as_tensor(karate.dense_adjacency))
    lb = torch.full((sims, 1), float(np.asarray(log1m_beta)))
    g16 = torch.full((sims, 1), float(gamma) * 65536.0)
    pi, pr = sir_update_plain(ti, tr, counts, lb, g16,
                              torch.as_tensor(words.astype(np.int64)))
    assert pi.dtype == dt and pr.dtype == dt
    np.testing.assert_array_equal(pr.numpy().astype(np.float32), np.asarray(jr))
    diff = pi.numpy().astype(np.float32) != np.asarray(ji)
    thresh = -np.expm1(counts.numpy() * np.float32(np.asarray(log1m_beta))) * 65536.0
    near = np.abs((words & 0xFFFF).astype(np.float32) - thresh) <= 1.0
    assert not (diff & ~near).any()
    assert diff.sum() <= 1e-3 * diff.size
    assert (pi.numpy() != ti.numpy()).any()  # the step did something


@pytest.mark.parametrize("matmul", ["auto", "bf16", "int8"])
def test_counts_are_exact_above_256(matmul):
    """A star with 300 infected leaves gives the centre a count of exactly
    300, and 297 with three of them healthy, on every count route the CPU
    has (a bf16 result could not hold 297: above 256 it steps by 2)."""
    star = graph_from_edges(301, [(0, k) for k in range(1, 301)], name="star")
    device = torch.device("cpu")
    a = mc_sir.device_adjacency(star, mc_sir._resolve_matmul(matmul, device), device)
    i = torch.ones((3, 301), dtype=torch.int8)
    i[:, 0] = 0
    i[2, 1:4] = 0
    counts = mc_sir.count_product(i, a)
    assert counts.dtype in (torch.float32, torch.int32)
    assert counts[:, 0].tolist() == [300, 300, 297]
    assert counts[0, 1:].tolist() == [0] * 300
    assert float(torch.tensor(297.0).to(torch.bfloat16)) != 297.0


def testdevice_adjacency_is_built_once_per_graph():
    g = graph_from_edges(13, [(0, 1), (1, 2), (5, 12)], name="tiny")
    a = mc_sir.device_adjacency(g, "f32", torch.device("cpu"))
    assert a.shape == (13, 13) and float(a.sum()) == 6.0
    assert mc_sir.device_adjacency(g, "f32", torch.device("cpu")) is a  # cached
    with pytest.raises(ValueError, match="matmul"):
        mc_sir._resolve_matmul("f16", torch.device("cpu"))


def test_label_means_match_jax_within_5_standard_errors(karate):
    sims, T = 20000, 8
    nodes, beta, gamma = [0, 33], 0.3, 0.15
    js, ji, jr = jax_simulate_sir(karate, nodes, beta, gamma, sims=sims, max_time=T,
                                  key=jax.random.PRNGKey(1))
    ts, ti, tr = simulate_sir(_port_graph(karate), nodes, beta, gamma, sims=sims,
                              max_time=T, seed=1, device="cpu")
    for got, want in ((ts, js), (ti, ji), (tr, jr)):
        assert got.shape == (T, karate.n_nodes) and got.dtype == np.float64
        se = np.sqrt((got * (1 - got) + want * (1 - want)) / sims)
        assert (np.abs(got - want) <= 5 * se + 1e-12).all()
    np.testing.assert_allclose(ts + ti + tr, 1.0, atol=1e-6)
    assert (np.diff(tr, axis=0) >= 0).all()  # recovered never decreases
    assert (ti[0, nodes] == 1.0).all() and ti[0].sum() == 2.0
    assert tr[-1].mean() > 0.05  # the epidemic really ran


@pytest.mark.parametrize("coins", ["bits32", "uniform"])
def test_plain_coin_modes_agree_with_the_fused_path(karate, coins):
    g = _port_graph(karate)
    kw = dict(sims=8000, max_time=6, device="cpu")
    ref = simulate_sir(g, [0], 0.4, 0.2, seed=3, **kw)
    got = simulate_sir(g, [0], 0.4, 0.2, seed=4, coins=coins, **kw)
    for a, b in zip(got, ref):
        se = np.sqrt((a * (1 - a) + b * (1 - b)) / 8000)
        assert (np.abs(a - b) <= 5 * se + 1e-12).all()
    again = simulate_sir(g, [0], 0.4, 0.2, seed=4, coins=coins, **kw)
    np.testing.assert_array_equal(again[1], got[1])  # seeded: reproducible


@pytest.mark.parametrize("coins", ["auto", "bits16", "rbg16", "pallas"])
def test_fused_coin_names_share_one_stream(karate, coins):
    g = _port_graph(karate)
    kw = dict(sims=300, max_time=5, seed=11, device="cpu")
    ref = simulate_sir_counts(g, [2, 5], 0.3, 0.1, **kw)
    np.testing.assert_array_equal(simulate_sir_counts(g, [2, 5], 0.3, 0.1, coins=coins, **kw),
                                  ref)
    with pytest.raises(ValueError, match="coins"):
        simulate_sir_counts(g, [2, 5], 0.3, 0.1, coins="dice", **kw)


def test_beta_zero_spreads_nothing_and_gamma_one_recovers_all(karate):
    g = _port_graph(karate)
    s, i, r = simulate_sir(g, [4, 9], 0.0, 1.0, sims=200, max_time=4, device="cpu")
    assert s[-1].sum() == g.n_nodes - 2
    assert i[1:].sum() == 0.0 and (r[1:, [4, 9]] == 1.0).all()
    s, i, r = simulate_sir(g, [4, 9], 0.0, 0.0, sims=200, max_time=4, device="cpu")
    assert (i[:, [4, 9]] == 1.0).all() and r.sum() == 0.0


def test_counts_many_equals_per_trial_counts(karate):
    """Trials that share a dispatch draw the streams they would draw alone,
    whatever the chunking."""
    g = _port_graph(karate)
    trials = [([0, 3], 0.3, 0.1), ([7], 0.2, 0.3), ([1, 2, 30], 0.45, 0.05)]
    seeds = [5, 9, 123456789012345]
    kw = dict(sims=257, max_time=6, device="cpu")  # sims * n is not a multiple of 4
    many = simulate_sir_counts_many(g, trials, seeds=seeds, **kw)
    for (nodes, b, gm), sd, got in zip(trials, seeds, many):
        want = simulate_sir_counts(g, nodes, b, gm, seed=sd, **kw)
        assert got.shape == (6, 3, g.n_nodes) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.sum(1), 257.0)
    chunked = simulate_sir_counts_many(g, trials, seeds=seeds, trials_chunk=2, **kw)
    for a, b in zip(chunked, many):
        np.testing.assert_array_equal(a, b)
    probs = simulate_sir_many(g, trials, seeds=seeds, **kw)
    np.testing.assert_array_equal(probs[1][2], many[1][:, 2].astype(np.float64) / 257.0)
    default = simulate_sir_counts_many(g, trials[:2], **kw)  # default seeds differ per trial
    assert not np.array_equal(default[0], many[0])
    with pytest.raises(ValueError, match="seeds"):
        simulate_sir_counts_many(g, trials, seeds=[1], **kw)
    assert simulate_sir_counts_many(g, [], **kw) == []


def test_sims_chunks_and_per_sim_share_one_schedule(karate):
    g = _port_graph(karate)
    kw = dict(sims=120, max_time=5, seed=8, device="cpu")
    whole = simulate_sir_counts(g, [0], 0.3, 0.2, **kw)
    chunked = simulate_sir_counts(g, [0], 0.3, 0.2, sims_chunk=50, **kw)  # 3 x 40
    assert chunked.sum(1).max() == 120.0 and not np.array_equal(whole, chunked)
    s, i, r = simulate_sir_per_sim(g, [0], 0.3, 0.2, sims_chunk=50, **kw)
    assert s.shape == (120, 5, g.n_nodes) and s.dtype == np.uint8
    np.testing.assert_array_equal(np.stack([x.sum(0) for x in (s, i, r)], 1), chunked)
    assert ((s + i + r) == 1).all()
    stats = sir_per_sim_stats(s, i, r)
    np.testing.assert_allclose(stats["mean"][1], chunked[:, 1] / 120.0)
    np.testing.assert_allclose(stats["std"], np.sqrt(stats["mean"] * (1 - stats["mean"])))
    ragged = simulate_sir_counts(g, [0], 0.3, 0.2, sims=100, max_time=3, seed=8,
                                 sims_chunk=30, device="cpu")  # 30, 30, 30, 10
    np.testing.assert_array_equal(ragged.sum(1), 100.0)


def test_sir_step_wrapper_checks_and_cpu_launch_count():
    i = torch.zeros((6, 5), dtype=torch.int8)
    i[:, 0] = 1
    r = torch.zeros_like(i)
    counts = torch.ones((6, 5))
    lb = torch.log1p(-torch.tensor([0.5, 0.2]))
    g16 = torch.tensor([0.1, 0.9]) * 65536.0
    seeds = torch.tensor([1, 2], dtype=torch.int64)
    before = sir_step.launches
    i2, r2, words = sir_step(i, r, counts, lb, g16, seeds, 1, sims=3, return_words=True)
    assert sir_step.launches == before  # CPU calls launch nothing
    assert words.shape == (6, 5)
    assert torch.equal(words[3:].reshape(-1), philox4x32_words(2, 1, 15, device="cpu"))
    assert ((i2 + r2) <= 1).all() and i2.dtype == torch.int8
    with pytest.raises(ValueError, match="multiple of sims"):
        sir_step(i, r, counts, lb, g16, seeds, 1, sims=4)
    with pytest.raises(ValueError, match="seeds"):
        sir_step(i, r, counts, lb, g16, seeds[:1], 1, sims=3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        m = lambda t: t.to("meta")
        sir_step(m(i), m(r), m(counts), m(lb), m(g16), m(seeds), 1, sims=3)
    with pytest.raises(ValueError, match="seed"):
        philox4x32_words(-1, 0, 4, device="cpu")


def test_fold_seed_and_auto_trials_chunk():
    seeds = {mc_sir.fold_seed(0, k) for k in range(1000)}
    assert len(seeds) == 1000 and all(0 <= s < 2**63 for s in seeds)
    assert mc_sir.fold_seed(1, 5) != mc_sir.fold_seed(2, 5)
    cpu = torch.device("cpu")
    assert mc_sir.auto_trials_chunk(34, 100, cpu) == 32  # capped
    assert mc_sir.auto_trials_chunk(33696, 10000, cpu) == 1  # never below one
