"""Port parity: ``gn_ode_sir_tpu_torch.parallel`` against ``gn_ode_sir_tpu.parallel``.

The port's parallel code runs as two gloo groups on the CPU, started once for
the module: 2 processes on a ("data",) mesh and 4 on a (2, 2) ("data",
"edge") mesh (``tests/torch_parallel_ranks.py``, which imports no JAX). The
JAX side runs here, on the conftest's virtual CPU devices (a 2- and a
4-device mesh), from the same seeded numpy inputs. Tolerances: training-step
losses within 1e-6, parameter leaves after one SGD step within 1e-5 (SGD,
as the JAX package's own multi-graph tests: Adam's first step turns
rounding noise in a near-zero gradient into a full step), edge-sharded
forward and gradients within 1e-5, predictions within 1e-5, the sharded
simulator's means to Monte-Carlo tolerance (mean |ΔI| < 0.02 at 8,000
simulations), and exact equality where nothing but placement differs
(``fit_ensemble(mesh=)`` against the unsharded run, ``cli.infer --spmd``
against one process).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gn_ode_sir_tpu.graphs import load_graph as jax_load_graph
from gn_ode_sir_tpu.graphs import pad_graphs as jax_pad_graphs
from gn_ode_sir_tpu.models import GNODE as JaxGNODE
from gn_ode_sir_tpu.ops.adjacency import adjacency_from_graph as jax_adjacency
from gn_ode_sir_tpu.parallel import make_mesh as jax_make_mesh
from gn_ode_sir_tpu.parallel import spmd as jax_spmd
from gn_ode_sir_tpu.parallel import simulate_sir_sharded as jax_simulate_sir_sharded
from gn_ode_sir_tpu.train import multigraph_adj_fns as jax_multigraph_adj_fns
from gn_ode_sir_tpu_torch.graphs import Graph
from gn_ode_sir_tpu_torch.parallel import init_distributed
from gn_ode_sir_tpu_torch.parallel.distributed import free_port

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LOSS_TOL, LEAF_TOL, EDGE_TOL, PRED_TOL = 1e-6, 1e-5, 1e-5, 1e-5
HIDDEN, MAX_TIME, B = 8, 6, 8
SGD_LR = 0.1  # torch_parallel_ranks.SGD_LR


def _arrays(g, name):
    return {"n": int(g.n_nodes), "src": np.asarray(g.src), "dst": np.asarray(g.dst),
            "name": name}


def _batch(rng, n_nodes, graph_idx=None, weight=None, node_mask=None, seeds=2):
    """A trial batch of B rows: ``seeds`` infected nodes each (within the
    row's real nodes), labels uniform in [0, 1)."""
    n_real = np.full(B, n_nodes) if node_mask is None else node_mask.sum(1).astype(int)
    i0 = np.zeros((B, n_nodes), np.float32)
    for b in range(B):
        i0[b, rng.choice(n_real[b], seeds, replace=False)] = 1.0
    s0 = 1.0 - i0 if node_mask is None else (1.0 - i0) * node_mask
    return {"s0": s0.astype(np.float32), "i0": i0, "r0": np.zeros_like(i0),
            "beta": np.full(B, 0.3, np.float32), "gamma": np.full(B, 0.2, np.float32),
            "weight": np.ones(B, np.float32) if weight is None else weight,
            "labels": rng.random((B, MAX_TIME, n_nodes, 3)).astype(np.float32),
            "graph_idx": np.zeros(B, np.int32) if graph_idx is None else graph_idx}


def _mg_graphs(sizes):
    return [jax_load_graph("none", n_random=n, seed=s) for n, s in sizes]


def _inputs(karate, g50, tmp):
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        np.asarray, JaxGNODE(hidden=HIDDEN, max_time=MAX_TIME).init(jax.random.PRNGKey(0)))
    mg3, mg2 = _mg_graphs(((12, 0), (20, 1), (16, 2))), _mg_graphs(((12, 0), (20, 1)))
    b3 = jax_pad_graphs(mg3, node_multiple=4, edge_multiple=16)
    b2 = jax_pad_graphs(mg2, node_multiple=4, edge_multiple=16)
    gi3 = np.asarray([0, 1, 2, 1, 0, 2, 1, 0], np.int32)
    gi_grouped = np.asarray([0, 0, 0, 0, 1, 1, 1, 1], np.int32)
    gi2 = np.asarray([0, 1] * (B // 2), np.int32)
    nm3 = np.asarray(b3.node_mask)
    I = {
        "hidden": HIDDEN, "max_time": MAX_TIME, "params": params,
        "g50": _arrays(g50, "gnp50"), "karate": _arrays(karate, "karate"),
        "mg3": [_arrays(g, f"g{k}") for k, g in enumerate(mg3)],
        "mg2": [_arrays(g, f"g{k}") for k, g in enumerate(mg2)],
        "batch50": _batch(rng, g50.n_nodes),
        "batch_mg3": _batch(rng, b3.n_max, gi3, rng.uniform(0.2, 2.0, B).astype(np.float32),
                            nm3[gi3]),
        "batch_mg3_grouped": _batch(rng, b3.n_max, gi_grouped,
                                    rng.uniform(0.2, 2.0, B).astype(np.float32),
                                    nm3[gi_grouped]),
        "batch_mg2": _batch(rng, b2.n_max, gi2, node_mask=np.asarray(b2.node_mask)[gi2]),
        "params_k": jax.tree_util.tree_map(
            np.asarray, JaxGNODE(hidden=HIDDEN, max_time=8).init(jax.random.PRNGKey(1))),
    }
    bk = _batch(rng, karate.n_nodes)
    I["batch_k"] = {k: bk[k] for k in ("s0", "i0", "r0", "gamma")}
    I["batch_k"]["beta"] = rng.uniform(0.1, 0.5, B).astype(np.float32)
    # the edge-sharded SpMM: 2 blocks, zero-weight padding at dst 0 (unsorted)
    e = g50.n_edges
    pad = (-e) % 2
    src = np.concatenate([g50.src, np.zeros(pad, np.int32)])
    dst = np.concatenate([g50.dst, np.zeros(pad, np.int32)])
    w = np.concatenate([rng.uniform(0.5, 1.5, e), np.zeros(pad)]).astype(np.float32)
    half = src.size // 2
    I["edge"] = {"n": g50.n_nodes, "src": src, "dst": dst, "w": w,
                 "blocks": [(0, half), (half, src.size)],
                 "x": rng.standard_normal((2, g50.n_nodes, 8)).astype(np.float32),
                 "g": rng.standard_normal((2, g50.n_nodes, 8)).astype(np.float32)}
    # the 2-D step: the edge list padded to a multiple of the edge axis
    I["edges50"] = {"src": src, "dst": dst,
                    "w": np.concatenate([np.ones(e), np.zeros(pad)]).astype(np.float32)}
    I["ens"] = _ensemble_inputs(karate, rng)
    I["infer"] = _infer_files(karate, tmp)
    return I


def _ensemble_inputs(karate, rng):
    n_trials, max_time = 10, 5
    triples = []
    for _ in range(n_trials):
        p = rng.dirichlet([2.0, 1.0, 1.0], size=(max_time, karate.n_nodes))
        triples.append((p[..., 0], p[..., 1], p[..., 2]))
    return {"n": karate.n_nodes, "hidden": 4, "max_time": max_time, "epochs": 2,
            "seeds": [0, 1, 2, 3],
            "nodes": [sorted(rng.choice(karate.n_nodes, 2, replace=False).tolist())
                      for _ in range(n_trials)],
            "beta": rng.uniform(0.1, 0.5, n_trials), "gamma": rng.uniform(0.05, 0.4, n_trials),
            "triples": triples,
            "splits": (np.arange(0, 6), np.arange(6, 8), np.arange(8, 10))}


def _infer_files(karate, tmp):
    from gn_ode_sir_tpu_torch.models import GNODE
    from gn_ode_sir_tpu_torch.train.checkpoint import save_params

    with open(tmp / "karate.pkl", "wb") as f:
        pickle.dump(Graph(n_nodes=karate.n_nodes, src=karate.src, dst=karate.dst), f)
    save_params(str(tmp / "ckpt"), GNODE(hidden=8, max_time=8).init(
        torch.Generator().manual_seed(5), device="cpu"))
    argv = ["--device", "cpu", "--ckpt", str(tmp / "ckpt"), "--dataset", str(tmp / "karate"),
            "--hidden", "8", "--maxTime", "8", "--I_indices", "[2, 5]", "[7]", "[0, 33]", "[9]",
            "[12]", "--beta", "0.3", "0.2", "0.4", "0.25", "0.35",
            "--gamma", "0.1", "0.4", "0.2", "0.3", "0.15"]
    return {"argv": argv, **{k: str(tmp / f"{k}.{ext}") for k, ext in (
        ("spmd_npz", "npz"), ("spmd_csv", "csv"), ("spmd_summary_csv", "csv"),
        ("npz", "npz"), ("csv", "csv"), ("summary_csv", "csv"))}}


def _run_group(world, inputs_path, out_dir):
    os.makedirs(out_dir)
    port = free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_ranks.py"), str(r), str(world),
         str(port), inputs_path, out_dir], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory, karate, random_graph):
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = _inputs(karate, random_graph, tmp)
    path = str(tmp / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    procs = {w: _run_group(w, path, str(tmp / f"group{w}")) for w in (2, 4)}
    outs = {}
    try:
        for w, ps in procs.items():
            outs[w] = [p.communicate(timeout=240)[0] for p in ps]
    finally:
        for p in (p for ps in procs.values() for p in ps):
            if p.poll() is None:
                p.kill()
    results = {}
    for w, ps in procs.items():
        bad = [f"rank {r} exited {p.returncode}:\n{outs[w][r][-3000:]}"
               for r, p in enumerate(ps) if p.returncode != 0]
        assert not bad, "\n".join(bad)
        results[w] = []
        for r in range(w):
            with open(tmp / f"group{w}" / f"rank{r}.pkl", "rb") as f:
                results[w].append(pickle.load(f))
    return inputs, results


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _assert_step(got, want_loss, want_params):
    assert abs(got["loss"] - float(want_loss)) <= LOSS_TOL
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=LEAF_TOL, rtol=0)


def _every_rank(results, world, case):
    """A case's result, after checking that every process returned the same."""
    first = results[world][0][case]
    for other in results[world][1:]:
        for a, b in zip(jax.tree_util.tree_leaves(first), jax.tree_util.tree_leaves(other[case])):
            np.testing.assert_array_equal(a, b)
    return first


def _jax_step(step, params, batch, *extra):
    p, _, loss = step(params, optax.sgd(SGD_LR).init(params), _jax_batch(batch), *extra)
    return loss, p


def _mesh(shape, names):
    return jax_make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])


def test_init_distributed_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert init_distributed("127.0.0.1:1", 1, 0) is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_no_cpu_fallback_without_a_card(monkeypatch):
    """Without a visible card, ``make_mesh()`` and a multi-process
    ``init_distributed`` that name no device type raise instead of running
    over gloo on the CPU; neither starts a group."""
    from gn_ode_sir_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        init_distributed("127.0.0.1:1", 2, 0)
    assert not torch.distributed.is_initialized()


def test_placements(groups):
    _, results = groups
    got = _every_rank(results, 2, "placements")
    assert got == {"data": ["S(0)"], "replicated": ["R"]}


def test_spmd_train_step_equals_jax(groups):
    inputs, results = groups
    got = _every_rank(results, 2, "step")
    from gn_ode_sir_tpu.graphs.graph import Graph as JaxGraph

    jg = JaxGraph(n_nodes=inputs["g50"]["n"], src=inputs["g50"]["src"],
                  dst=inputs["g50"]["dst"])
    adj = jax_adjacency(jg)
    model = JaxGNODE(hidden=HIDDEN, max_time=MAX_TIME)
    step = jax_spmd.make_spmd_train_step(model, optax.sgd(SGD_LR), lambda gi: adj,
                                         _mesh((2,), ("data",)))
    loss, p = _jax_step(step, inputs["params"], inputs["batch50"])
    _assert_step(got["full"], loss, p)
    # missing weight/graph_idx take their neutral defaults: the same step
    assert got["minimal"]["loss"] == got["full"]["loss"]
    for a, b in zip(jax.tree_util.tree_leaves(got["minimal"]["params"]),
                    jax.tree_util.tree_leaves(got["full"]["params"])):
        np.testing.assert_array_equal(a, b)


def test_spmd_train_step_dropout_rng(groups):
    _, results = groups
    got = _every_rank(results, 2, "dropout")
    assert got["a"] == got["a2"], "the same seed must reproduce"
    assert got["a"] != got["b"], "dropout must draw from the seed"
    assert got["det"] != got["a"], "without dropout_rng the forward is deterministic"


def _jax_mg(inputs, key):
    graphs = [jax_load_graph("none", n_random=g["n"], seed=s)
              for g, s in zip(inputs[key], range(len(inputs[key])))]
    batch_g = jax_pad_graphs(graphs, node_multiple=4, edge_multiple=16)
    for g, d in zip(graphs, inputs[key]):
        np.testing.assert_array_equal(g.src, d["src"])
    adj_fn, mask_fn, aux = jax_multigraph_adj_fns(batch_g, kind="coo")
    return batch_g, adj_fn, mask_fn, jax.tree_util.tree_map(jnp.asarray, aux)


@pytest.mark.parametrize("case,batch", [("mg_coo", "batch_mg3"),
                                        ("mg_pallas2", "batch_mg3_grouped")])
def test_spmd_multigraph_step_equals_jax(groups, case, batch):
    """Per-sample COO rows (heterogeneous blocks), and the port's K1 plans per
    graph (each block on one graph) — against JAX's step on the COO rows."""
    inputs, results = groups
    got = _every_rank(results, 2, case)
    _, adj_fn, mask_fn, aux = _jax_mg(inputs, "mg3")
    step = jax_spmd.make_spmd_train_step(
        JaxGNODE(hidden=HIDDEN, max_time=MAX_TIME), optax.sgd(SGD_LR), adj_fn,
        _mesh((2,), ("data",)), aux_example=aux, node_mask_fn=mask_fn)
    loss, p = _jax_step(step, inputs["params"], inputs[batch], aux)
    _assert_step(got, loss, p)


def test_edge_sharded_spmm_equals_jax(groups):
    inputs, results = groups
    e = inputs["edge"]
    mesh = _mesh((2,), ("data",))

    def local(s, d, w, x, g):
        y, vjp = jax.vjp(lambda xx, ww: jax_spmd.spmm_edge_sharded(s, d, xx, e["n"], "data", ww),
                         x, w)
        dx, dw = vjp(g)
        return y, dx, dw

    f = jax.shard_map(local, mesh=mesh, in_specs=(P("data"), P("data"), P("data"), P(), P()),
                      out_specs=(P(), P(), P("data")), check_vma=False)
    y, dx, dw = f(*(jnp.asarray(e[k]) for k in ("src", "dst", "w", "x", "g")))
    ranks = results[2]
    for r in ranks:
        np.testing.assert_allclose(r["edge_spmm"]["y"], np.asarray(y), atol=EDGE_TOL, rtol=0)
        np.testing.assert_allclose(r["edge_spmm"]["dx"], np.asarray(dx), atol=EDGE_TOL, rtol=0)
    got_dw = np.concatenate([r["edge_spmm"]["dw"] for r in ranks])
    np.testing.assert_allclose(got_dw, np.asarray(dw), atol=EDGE_TOL, rtol=0)
    # and the dense product: y = A_w x
    a = np.zeros((e["n"], e["n"]), np.float32)
    np.add.at(a, (e["dst"], e["src"]), e["w"])
    np.testing.assert_allclose(ranks[0]["edge_spmm"]["y"], a @ e["x"], atol=EDGE_TOL, rtol=0)


def test_edge_sharded_follows_w_updated_in_place(groups):
    """K1's plans hold their own copies of the block's weights: after an
    optimizer step on ``w`` the same adjacency applies the new weights,
    bit for bit as one built from them afresh, and the dense product."""
    inputs, results = groups
    e = inputs["edge"]
    ranks = [r["edge_w_update"] for r in results[2]]
    for r in ranks:
        np.testing.assert_array_equal(r["after"], r["fresh"])
        assert not np.allclose(r["after"], r["before"], atol=EDGE_TOL)
    a = np.zeros((e["n"], e["n"]), np.float32)
    np.add.at(a, (e["dst"], e["src"]), np.concatenate([r["w"] for r in ranks]))
    np.testing.assert_allclose(ranks[0]["after"], a @ e["x"], atol=EDGE_TOL, rtol=0)


def test_spmd_train_step_2d_sees_edges_changed_in_place(groups):
    _, results = groups
    got = _every_rank(results, 4, "step_2d_edges_changed")
    assert got["again"]["loss"] == got["fresh"]["loss"] != got["first"]["loss"]
    for a, b in zip(jax.tree_util.tree_leaves(got["again"]["params"]),
                    jax.tree_util.tree_leaves(got["fresh"]["params"])):
        np.testing.assert_array_equal(a, b)


def test_sharded_sim_means_agree_with_jax(groups, karate):
    _, results = groups
    got = _every_rank(results, 2, "sim")
    s, i, r = got["s"], got["i"], got["r"]
    assert s.dtype == np.float64 and s.shape == (20, karate.n_nodes)
    np.testing.assert_allclose(s + i + r, 1.0, atol=1e-9)
    assert np.all(np.diff(r, axis=0) >= -1e-12)
    _, ij, _ = jax_simulate_sir_sharded(karate, [0], 0.3, 0.2, mesh=_mesh((2,), ("data",)),
                                        sims=8000, key=jax.random.PRNGKey(2))
    assert np.abs(i - ij).mean() < 0.02


def test_spmd_predict_equals_jax(groups):
    inputs, results = groups
    got = _every_rank(results, 2, "predict")
    from gn_ode_sir_tpu.cli.infer import _summary_reduce
    from gn_ode_sir_tpu.graphs.graph import Graph as JaxGraph

    k = inputs["karate"]
    adj = jax_adjacency(JaxGraph(n_nodes=k["n"], src=k["src"], dst=k["dst"]))
    model = JaxGNODE(hidden=HIDDEN, max_time=8)
    mesh = _mesh((2,), ("data",))
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params_k"])
    full = jax_spmd.make_spmd_predict_fn(model, lambda gi: adj, mesh)(
        params, _jax_batch(inputs["batch_k"]))
    np.testing.assert_allclose(got["full"], np.asarray(full), atol=PRED_TOL, rtol=0)
    summary = jax_spmd.make_spmd_predict_fn(model, lambda gi: adj, mesh,
                                            reduce_fn=_summary_reduce)(
        params, _jax_batch(inputs["batch_k"]))
    np.testing.assert_allclose(got["summary"], np.asarray(summary), atol=PRED_TOL, rtol=0)
    batch_g, adj_fn, mask_fn, aux = _jax_mg(inputs, "mg2")
    b = {k: v for k, v in inputs["batch_mg2"].items() if k not in ("weight", "labels")}
    masked = jax_spmd.make_spmd_predict_fn(model, adj_fn, mesh, aux_example=aux,
                                           node_mask_fn=mask_fn)(params, _jax_batch(b), aux)
    np.testing.assert_allclose(got["masked"], np.asarray(masked), atol=PRED_TOL, rtol=0)
    n_real = np.asarray(batch_g.n_nodes)[b["graph_idx"]]
    for j in range(B):
        assert not got["masked"][:, j, n_real[j]:].any()


def test_infer_spmd_equals_one_process(groups):
    import contextlib
    import io

    from gn_ode_sir_tpu_torch.cli import infer

    inputs, _ = groups
    f = inputs["infer"]
    with contextlib.redirect_stdout(io.StringIO()):
        infer.main([*f["argv"], "--out", f["npz"], "--summary_csv", f["csv"]])
        infer.main([*f["argv"], "--summary_only", "--dispatch_batch", "2",
                    "--summary_csv", f["summary_csv"]])
    one, spmd = np.load(f["npz"], allow_pickle=True), np.load(f["spmd_npz"], allow_pickle=True)
    assert sorted(one.files) == sorted(spmd.files)
    for k in one.files:
        np.testing.assert_array_equal(one[k], spmd[k])
    for a, b in (("csv", "spmd_csv"), ("summary_csv", "spmd_summary_csv")):
        with open(f[a]) as fa, open(f[b]) as fb:
            assert fa.read() == fb.read()


def _ensemble_reference(inputs):
    import torch_parallel_ranks

    return torch_parallel_ranks.ensemble_run(inputs)


@pytest.mark.parametrize("world,case,part", [(2, "ensemble", None),
                                             (4, "ensemble_2d", "data_axis"),
                                             (4, "ensemble_2d", "member_axis_only")])
def test_fit_ensemble_mesh_equals_unsharded(groups, world, case, part):
    inputs, results = groups
    want = _ensemble_reference(inputs)
    for r in results[world]:
        got = r[case] if part is None else r[case][part]
        assert len(got["history"]) == len(want["history"])
        for (ea, ta, va), (eb, tb, vb) in zip(got["history"], want["history"]):
            assert ea == eb
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(va, vb)
        for k in ("best_epoch", "best_val_loss", "test_loss", "test_loss_all"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("params", "best_params", "exp_avg"):
            for a, b in zip(jax.tree_util.tree_leaves(got[k]), jax.tree_util.tree_leaves(want[k])):
                np.testing.assert_array_equal(a, b)


def test_fit_ensemble_refuses_bad_axes():
    from gn_ode_sir_tpu_torch.train import fit_ensemble

    with pytest.raises(ValueError, match="requires a mesh"):
        fit_ensemble(None, None, None, None, [], [], [], None, seeds=[0], data_axis="data")


def test_spmd_train_step_2d_equals_jax(groups):
    inputs, results = groups
    got = _every_rank(results, 4, "step_2d")
    e = inputs["edges50"]
    model = JaxGNODE(hidden=HIDDEN, max_time=MAX_TIME)
    step = jax_spmd.make_spmd_train_step_2d(model, optax.sgd(SGD_LR),
                                            _mesh((2, 2), ("data", "edge")), inputs["g50"]["n"])
    loss, p = _jax_step(step, inputs["params"], inputs["batch50"],
                        *(jnp.asarray(e[k]) for k in ("src", "dst", "w")))
    _assert_step(got, loss, p)


def test_spmd_multigraph_step_2d_equals_jax(groups):
    inputs, results = groups
    got = _every_rank(results, 4, "mg_step_2d")
    batch_g, _, mask_fn, aux = _jax_mg(inputs, "mg3")
    step = jax_spmd.make_spmd_multigraph_train_step_2d(
        JaxGNODE(hidden=HIDDEN, max_time=MAX_TIME), optax.sgd(SGD_LR),
        _mesh((2, 2), ("data", "edge")), batch_g.n_max, aux, node_mask_fn=mask_fn)
    loss, p = _jax_step(step, inputs["params"], inputs["batch_mg3"], aux)
    _assert_step(got, loss, p)
