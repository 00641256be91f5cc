"""DMP on the port's serving path (``models/dmp.py::DMPSIR.predict``,
``cli/infer.py --model dmp``): against the benchmark's float64 reference
(``perfbench/reference/dmp.py``) and the JAX package on the CPU, the
rewrites of the recursion bit-equal to the recursion they replaced, the
counters, and what a dispatch uploads."""

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.graphs.graph import graph_from_networkx as jax_graph_from_networkx
from gn_ode_sir_tpu.models import DMPSIR as JaxDMPSIR
from gn_ode_sir_tpu_torch.cli import infer, worker
from gn_ode_sir_tpu_torch.graphs import load_graph
from gn_ode_sir_tpu_torch.graphs.graph import Graph, graph_from_edges
from gn_ode_sir_tpu_torch.models import DMPSIR, dmp
from gn_ode_sir_tpu_torch.ops.segment import segment_prod
from perfbench import inputs
from perfbench.reference import dmp as ref

torch.set_num_threads(1)

# Every marginal is 1 less sums built over up to 19 steps, each rounded at
# float32's 6e-8 near 1 (Pi = 1 - Ps - Pr, Pr accumulating gamma Pi): at
# most about 19 x 6e-8 = 1.1e-6 apart from float64; these graphs read
# 3.5e-7 (power law, hub of 33) and 2.6e-7 (karate).
REF_ATOL = 1e-6
JAX_ATOL = 1e-5  # as tests/test_torch_dmp.py: XLA's segment products associate otherwise


def _port(jg):
    return Graph(n_nodes=jg.n_nodes, src=jg.src, dst=jg.dst, name=jg.name)


def _powerlaw(n=120, directed=800, seed=0):
    pairs = inputs.powerlaw_pairs(n, directed, seed)
    return graph_from_edges(n, pairs, name="powerlaw"), pairs


def _scenarios(n, b, seed):
    rng = np.random.default_rng(seed)
    seeds = [sorted(int(v) for v in rng.choice(n, 2, replace=False)) for _ in range(b)]
    return (seeds, rng.uniform(0.1, 0.5, b).astype(np.float32),
            rng.uniform(0.1, 0.5, b).astype(np.float32))


def _predict(g, seeds, beta, gamma, max_time=20):
    model = DMPSIR.from_graph(g, max_time=max_time)
    arrays = [torch.as_tensor(a) for a in infer.scenario_batch(g.n_nodes, seeds, beta, gamma)]
    return model.predict({}, model.edges("cpu"), *arrays)


def _seed_recursion(src, dst, cave, w, gamma, seeds, *, n_nodes, max_time):
    """The recursion as the port had it before serving: three segment
    products a step, the cavity term a product into E + 1 buckets, the rates
    materialized [B, E] / [B, n]. Returns [B, T, n, 3]."""
    E = src.shape[0]
    edge_dim = w.dim() - 1
    gamma_src = gamma[..., src]
    node_prod = lambda theta: segment_prod(theta, dst, n_nodes, dim=edge_dim)

    def mulmul(theta):
        theta_cav = segment_prod(theta, cave, E + 1, dim=edge_dim)[..., :E]
        return node_prod(theta)[..., src] / theta_cav

    ps_0, pi_0, pr_0 = 1.0 - seeds, seeds, torch.zeros_like(seeds)
    out = [torch.stack([ps_0, pi_0, pr_0], dim=-1)]
    ps_i0 = ps_0[..., src]
    phi0 = 1.0 - ps_i0
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


@pytest.mark.parametrize("graph", ["powerlaw", "karate"])
def test_predict_matches_the_float64_reference(graph, request):
    if graph == "powerlaw":
        g, pairs = _powerlaw()
        src, dst = (torch.as_tensor(a) for a in inputs.directed(pairs))
    else:
        g = _port(request.getfixturevalue("karate"))
        src, dst = torch.as_tensor(g.src), torch.as_tensor(g.dst)
    seeds, beta, gamma = _scenarios(g.n_nodes, 12, 4)
    got = _predict(g, seeds, beta, gamma)
    i0 = torch.as_tensor(infer.scenario_batch(g.n_nodes, seeds, beta, gamma)[1]).double()
    want = ref.predict(src, dst, g.n_nodes, i0, torch.as_tensor(beta).double(),
                       torch.as_tensor(gamma).double(), max_time=20, block=5)
    assert got.shape == (20, 12, g.n_nodes, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), atol=REF_ATOL, rtol=0)
    np.testing.assert_allclose(ref.summaries(got.double()).numpy(), ref.summaries(want).numpy(),
                               atol=REF_ATOL, rtol=0)


def test_reference_is_exact_on_a_tree():
    """On a tree DMP is exact: a leaf's only neighbour is its parent, so
    P(leaf still susceptible) is 1 - beta at t = 1 and (1 - beta)(1 - beta
    (1 - gamma)) at t = 2 when the parent is the seed; the parent recovers
    with probability gamma at t = 1."""
    g = _port(jax_graph_from_networkx(nx.balanced_tree(2, 4), name="tree"))
    leaf = g.n_nodes - 1
    parent = int(g.src[g.dst == leaf][0])
    seeds = torch.zeros((1, g.n_nodes), dtype=torch.float64)
    seeds[0, parent] = 1.0
    beta, gamma = 0.3, 0.25
    m = ref.predict(torch.as_tensor(g.src), torch.as_tensor(g.dst), g.n_nodes, seeds,
                    torch.tensor([beta], dtype=torch.float64),
                    torch.tensor([gamma], dtype=torch.float64), max_time=3)[:, 0]
    assert float(m[1, leaf, 0]) == pytest.approx(1 - beta, abs=1e-12)
    assert float(m[2, leaf, 0]) == pytest.approx((1 - beta) * (1 - beta * (1 - gamma)), abs=1e-12)
    assert float(m[1, parent, 2]) == pytest.approx(gamma, abs=1e-12)
    torch.testing.assert_close(m.sum(-1), torch.ones_like(m[..., 0]), atol=1e-12, rtol=0)


def test_reference_cavity_excludes_one_edge_by_prefix_and_suffix():
    """The reference's exclusion products against a loop over the edges, on
    a graph with one-way edges (their cavity is the full product)."""
    src = torch.tensor([1, 2, 3, 0, 0, 2, 3, 1])
    dst = torch.tensor([0, 0, 0, 1, 2, 1, 1, 3])
    theta = torch.linspace(0.5, 0.95, 8, dtype=torch.float64)[None]
    cavity, full = ref.products(theta, ref.segments(src, dst, 4))
    for e in range(8):
        i, j = int(src[e]), int(dst[e])
        into_i = [k for k in range(8) if int(dst[k]) == i and int(src[k]) != j]
        assert float(cavity[0, e]) == pytest.approx(float(theta[0, into_i].prod()), rel=1e-14)
    for i in range(4):
        assert float(full[0, i]) == pytest.approx(float(theta[0, dst == i].prod()), rel=1e-14)


def test_summaries_chunked_equal_unchunked():
    g, _ = _powerlaw()
    model = DMPSIR.from_graph(g, max_time=20)
    arrays = infer.scenario_batch(g.n_nodes, *_scenarios(g.n_nodes, 7, 5))
    whole = infer.predict_summaries(model, {}, model.edges("cpu"), *arrays)
    for cap in (1, 3, 7):
        assert infer.predict_summaries(model, {}, model.edges("cpu"), *arrays,
                                       dispatch_batch=cap) == whole


def test_infer_main_serves_dmp_without_a_checkpoint(tmp_path, capsys):
    argv = ["--model", "dmp", "--dataset", "none", "--maxTime", "12", "--device", "cpu",
            "--I_indices", "[2, 5]", "[7]", "--beta", "0.3", "0.2", "--gamma", "0.1", "0.4"]
    out = tmp_path / "p.npz"
    assert infer.main([*argv, "--out", str(out)]) == 0
    g = load_graph("none")
    direct = _predict(g, [[2, 5], [7]], [0.3, 0.2], [0.1, 0.4], max_time=12)  # [T, B, n, 3]
    got = np.load(out, allow_pickle=True)
    for k, name in enumerate("SIR"):
        np.testing.assert_array_equal(got[name], direct[..., k].transpose(0, 1).numpy())
    capsys.readouterr()
    assert infer.main([*argv, "--summary_only"]) == 0
    with pytest.raises(SystemExit, match="no parameters"):
        infer.main([*argv, "--ckpt", str(tmp_path)])
    with pytest.raises(SystemExit, match="needs --ckpt"):
        infer.main([a if a != "dmp" else "ode_nn" for a in argv])


def test_run_many_equals_jax_on_karate(karate):
    """The JAX package's ``run_many`` and the port's serving path, which
    ``run_many`` now shares, on karate."""
    seeds, beta, gamma = _scenarios(karate.n_nodes, 6, 6)
    want = np.asarray(JaxDMPSIR.from_graph(karate).run_many(seeds, jnp.asarray(beta),
                                                            jnp.asarray(gamma), max_time=15))
    g = _port(karate)
    got = _predict(g, seeds, beta, gamma, max_time=15)
    np.testing.assert_allclose(got.movedim(0, 1).numpy(), want, atol=JAX_ATOL, rtol=0)
    many = DMPSIR.from_graph(g).run_many(seeds, beta, gamma, max_time=15, device="cpu")
    torch.testing.assert_close(many, got.movedim(0, 1), atol=0, rtol=0)


@pytest.mark.parametrize("one_way", [False, True])
def test_cavity_gather_is_the_scatter_product(one_way):
    """Rewrite 1: the reverse edge's theta gathered (1 where there is none)
    gives the bits of the product of each edge's theta into its reverse
    edge's bucket (E + 1 buckets, at most one value each)."""
    g, _ = _powerlaw()
    src, dst = g.src, g.dst
    if one_way:  # drop a third of the edges: some keep no reverse edge
        keep = np.random.default_rng(0).random(len(src)) > 0.33
        src, dst = src[keep], dst[keep]
    cave = dmp.cave_index(src, dst)
    assert bool((cave == len(src)).any()) is one_way
    edges = dmp.DmpEdges.build(src, dst, cave, g.n_nodes, device="cpu")
    theta = torch.rand((len(src), 5), generator=torch.Generator().manual_seed(1)) * 0.5 + 0.5
    scattered = segment_prod(theta, torch.as_tensor(cave).long(), len(src) + 1)  # [E, B]
    assert torch.equal(dmp._cavity(theta, edges), scattered[:len(src)])


def test_a_repeated_edge_is_refused():
    with pytest.raises(ValueError, match="repeated"):
        DMPSIR.from_graph(Graph(n_nodes=3, src=[0, 0, 1], dst=[1, 1, 0])).edges("cpu")


@pytest.mark.parametrize("rates", ["per_scenario", "per_edge_and_node"])
def test_one_node_product_a_step_is_the_seed_recursion(rates):
    """Rewrite 2: the node product taken once a step and used for the cavity
    products and the marginal (with rewrite 1 and the rates broadcast on the
    device) gives the bits of the recursion the port had before."""
    g, _ = _powerlaw(200, 1600, 1)
    seeds, beta, gamma = _scenarios(g.n_nodes, 9, 7)
    model = DMPSIR.from_graph(g)
    B, E, n = len(seeds), g.n_edges, g.n_nodes
    i0 = torch.as_tensor(infer.scenario_batch(n, seeds, beta, gamma)[1])
    if rates == "per_scenario":
        w, gam = torch.as_tensor(beta)[:, None], torch.as_tensor(gamma)[:, None]
        got = model.predict({}, model.edges("cpu"), 1 - i0, i0, 0 * i0, torch.as_tensor(beta),
                            torch.as_tensor(gamma)).movedim(0, 1)
    else:
        rng = np.random.default_rng(8)
        w = torch.as_tensor(rng.uniform(0.1, 0.5, (B, E)).astype(np.float32))
        gam = torch.as_tensor(rng.uniform(0.1, 0.5, (B, n)).astype(np.float32))
        got = model.run_many(seeds, w.numpy(), gam.numpy(), max_time=20, device="cpu")
    want = _seed_recursion(*(torch.as_tensor(a).long() for a in (g.src, g.dst, model.cave)),
                           w.expand(B, E).contiguous(), gam.expand(B, n).contiguous(), i0,
                           n_nodes=n, max_time=20)
    assert torch.equal(got, want)


def test_counters_count_edge_updates_and_node_products(monkeypatch):
    g, _ = _powerlaw()
    monkeypatch.setattr(dmp.dmp_recursion, "edge_updates", 0)
    monkeypatch.setattr(segment_prod, "calls", 0)
    _predict(g, *_scenarios(g.n_nodes, 6, 9), max_time=11)
    assert dmp.dmp_recursion.edge_updates == 6 * g.n_edges * 10
    assert segment_prod.calls == 10  # one node product a step
    DMPSIR.from_graph(g).run([3], 0.2, 0.1, max_time=4, device="cpu")
    assert dmp.dmp_recursion.edge_updates == 6 * g.n_edges * 10 + g.n_edges * 3
    assert segment_prod.calls == 13


def test_a_dispatch_uploads_only_the_scenario_arrays(monkeypatch):
    """The edge structure stays on the device from one dispatch to the
    next: a dispatch of B scenarios on n nodes uploads the scenario arrays,
    s0, i0, r0 [B, n] and beta, gamma [B], float32, and nothing else."""
    g, _ = _powerlaw()
    args = worker.build_parser().parse_args(["--model", "dmp", "--maxTime", "8",
                                             "--device", "cpu"])
    model, adj = worker.build_model_and_adj(args, g, device="cpu")
    assert isinstance(adj, dmp.DmpEdges) and adj is model.edges("cpu")
    with pytest.raises(ValueError, match="trainable"):
        worker.build_model(args, g.n_nodes)
    monkeypatch.setattr(infer._upload, "upload_bytes", 0)
    monkeypatch.setattr(infer._upload, "calls", 0)
    arrays = infer.scenario_batch(g.n_nodes, *_scenarios(g.n_nodes, 10, 3))
    infer.predict_summaries(model, {}, adj, *arrays, dispatch_batch=4)
    assert infer._upload.calls == 3
    assert infer._upload.upload_bytes == 3 * (3 * 4 * g.n_nodes * 4 + 2 * 4 * 4)
