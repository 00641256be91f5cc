"""Port parity: the serving entry point gn_ode_sir_tpu_torch.cli.infer against
the JAX package's cli.infer.

JAX-initialised params are converted with ``params_from_numpy`` and saved
with the port's ``save_params``; the port's ``infer.main`` scores scenarios
on them on the CPU. The JAX side scores the same params through its
library functions (``predict_scenarios``/``summarize``), which needs no
Orbax checkpoint. f32 probabilities agree to atol 1e-5.
"""

import csv
import json

import jax
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.cli import infer as jax_infer
from gn_ode_sir_tpu.cli import worker as jax_worker
from gn_ode_sir_tpu.graphs import load_graph as jax_load_graph
from gn_ode_sir_tpu_torch.cli import infer, worker
from gn_ode_sir_tpu_torch.graphs import load_graph
from gn_ode_sir_tpu_torch.train.checkpoint import (
    params_from_numpy,
    params_to_numpy,
    restore_params,
    save_params,
)

torch.set_num_threads(1)

ATOL = 1e-5
SCEN = ["--I_indices", "[2, 5]", "[7]", "[1, 4, 9]",
        "--beta", "0.3", "0.2", "0.25", "--gamma", "0.1", "0.4", "0.3"]
SEEDS, BETA, GAMMA = [[2, 5], [7], [1, 4, 9]], [0.3, 0.2, 0.25], [0.1, 0.4, 0.3]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(checkpoint dir, JAX params) for a hidden-8, maxTime-8 C7 model."""
    from gn_ode_sir_tpu.models.gnode import GNODE as JaxGNODE

    params = JaxGNODE(hidden=8, max_time=8).init(jax.random.PRNGKey(3))
    ckpt = tmp_path_factory.mktemp("ckpt")
    save_params(str(ckpt),
                params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return str(ckpt), params


def _common(ckpt, *extra):
    return ["--ckpt", ckpt, "--dataset", "none", "--hidden", "8", "--maxTime", "8",
            "--device", "cpu", *SCEN, *extra]


def _jax_scored(params, spmm="auto", summaries=False):
    args = jax_infer.build_parser().parse_args(
        ["--ckpt", "x", "--dataset", "none", "--hidden", "8", "--maxTime", "8",
         "--spmm", spmm, "--I_indices", "x"])
    g = jax_load_graph("none")
    model, adj = jax_worker.build_model_and_adj(args, g, batch_size=3)
    sb = jax_infer.scenario_batch(g.n_nodes, SEEDS, BETA, GAMMA)
    if summaries:
        return jax_infer.predict_summaries(model, params, adj, *sb)
    return jax_infer.predict_scenarios(model, params, adj, *sb)  # [T, B, n, 3]


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _assert_rows_close(a, b, atol=ATOL):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert int(ra["peak_time"]) == int(rb["peak_time"])
        for k in ("peak_infected_frac", "final_recovered_frac"):
            np.testing.assert_allclose(float(ra[k]), float(rb[k]), atol=atol)


@pytest.mark.parametrize("spmm", ["auto", "pallas2"])
def test_main_npz_and_summary_match_jax(served, tmp_path, capsys, spmm):
    ckpt, params = served
    out, summ = tmp_path / "pred.npz", tmp_path / "summary.csv"
    assert infer.main(_common(ckpt, "--spmm", spmm, "--out", str(out),
                              "--summary_csv", str(summ))) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["scenarios"] == 3 and printed["out"] == str(out)
    d = np.load(out, allow_pickle=True)
    assert d["S"].shape == (3, 8, 50)
    want = np.transpose(_jax_scored(params, spmm), (1, 0, 2, 3))  # [B, T, n, 3]
    for j, c in enumerate("SIR"):
        np.testing.assert_allclose(d[c], want[..., j], atol=ATOL)
    np.testing.assert_allclose(d["S"] + d["I"] + d["R"], 1.0, atol=1e-5)
    assert list(d["seed_sets"]) == ["2,5", "7", "1,4,9"]
    _assert_rows_close(_read_csv(summ), jax_infer.summarize(want))
    _assert_rows_close(printed["summary"], jax_infer.summarize(want))


def test_summary_only_matches_full_and_jax(served, tmp_path):
    ckpt, params = served
    full, skip = tmp_path / "full.npz", tmp_path / "absent.npz"
    c1, c2 = tmp_path / "full.csv", tmp_path / "summ.csv"
    assert infer.main(_common(ckpt, "--out", str(full), "--summary_csv", str(c1))) == 0
    assert infer.main(_common(ckpt, "--out", str(skip), "--summary_only",
                              "--summary_csv", str(c2))) == 0
    assert not skip.exists()
    d = np.load(full)
    host = infer.summarize(np.stack([d["S"], d["I"], d["R"]], axis=-1))
    _assert_rows_close(_read_csv(c2), host)
    _assert_rows_close(_read_csv(c1), host)
    _assert_rows_close(_read_csv(c2), _jax_scored(params, summaries=True))


def test_dispatch_batch_chunking_matches_unchunked(served, tmp_path):
    ckpt, _ = served
    args = infer.build_parser().parse_args(_common(ckpt))
    g = load_graph("none")
    model, adj = worker.build_model_and_adj(args, g, batch_size=2)
    params = infer.restore_params(ckpt, device="cpu")
    rng = np.random.default_rng(0)
    seeds = [sorted(rng.choice(g.n_nodes, 2, replace=False).tolist()) for _ in range(5)]
    sb = infer.scenario_batch(g.n_nodes, seeds, rng.uniform(0.1, 0.5, 5),
                              rng.uniform(0.1, 0.5, 5))
    whole = infer.predict_summaries(model, params, adj, *sb)
    chunked = infer.predict_summaries(model, params, adj, *sb, dispatch_batch=2)  # 2+2+1
    _assert_rows_close(whole, chunked, atol=1e-6)
    full = infer.predict_scenarios(model, params, adj, *sb)
    full_chunked = infer.predict_scenarios(model, params, adj, *sb, dispatch_batch=2)
    assert full.shape == full_chunked.shape == (8, 5, g.n_nodes, 3)
    np.testing.assert_allclose(full, full_chunked, atol=1e-6)
    with pytest.raises(ValueError):
        infer._chunked(lambda *c: c[0], sb, 0, batch_axis=0)
    # the CLI flag takes the same chunked path
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    assert infer.main(_common(ckpt, "--out", str(a))) == 0
    assert infer.main(_common(ckpt, "--out", str(b), "--dispatch_batch", "2")) == 0
    np.testing.assert_allclose(np.load(a)["I"], np.load(b)["I"], atol=1e-6)


@pytest.mark.parametrize("bad", [
    ["--hidden", "16"],  # architecture mismatch
    ["--I_indices", "[70]", "--beta", "0.2", "--gamma", "0.1"],  # node out of range
    ["--dispatch_batch", "0"],
])
def test_bad_requests_exit(served, bad):
    ckpt, _ = served
    with pytest.raises(SystemExit):
        infer.main([*_common(ckpt), *bad])


def test_missing_checkpoint_exits(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        infer.main(["--ckpt", str(tmp_path), "--dataset", "none", "--device", "cpu", *SCEN])


def test_device_cuda_raises_without_card(served):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: --device cuda is valid here")
    ckpt, _ = served
    argv = [a for a in _common(ckpt) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        infer.main(argv)  # the default device is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        worker.resolve_device("cuda")


def test_spmd_not_ported(served, tmp_path, capsys):
    """--spmd in a single process (no group) takes the plain path, as the
    JAX package does on one device: the same output bit for bit. Its split
    over a 2-process group is held in tests/test_torch_parallel.py."""
    ckpt, _ = served
    outs = {flag: str(tmp_path / f"p{flag}.npz") for flag in ("", "--spmd")}
    for flag, path in outs.items():
        assert infer.main(_common(ckpt, *([flag] if flag else []), "--out", path)) == 0
    capsys.readouterr()
    one, spmd = np.load(outs[""], allow_pickle=True), np.load(outs["--spmd"], allow_pickle=True)
    for k in ("S", "I", "R"):
        np.testing.assert_array_equal(one[k], spmd[k])


def test_unported_models_raise():
    """GCN and GIN build, so does the ell adjacency (the last kind ported),
    and a closed-form baseline is no trainable model."""
    for name in ("GCN", "GIN"):
        args = worker.build_parser().parse_args(["--model", name, "--hidden", "6", "--device", "cpu"])
        model = worker.build_model(args, 10)
        want = jax_worker.build_model(jax_worker.build_parser().parse_args(
            ["--model", name, "--hidden", "6"]), 10)
        assert type(model.gnn).__name__ == name
        assert (model.gnn.hidden_dim, model.gnn.penultimate_dim, model.gnn.window,
                model.gnn.input_dim, model.gnn.dropout) == (
            want.gnn.hidden_dim, want.gnn.penultimate_dim, want.gnn.window,
            want.gnn.input_dim, want.gnn.dropout)
    from gn_ode_sir_tpu_torch.ops.ell import EllAdj

    args = worker.build_parser().parse_args(["--spmm", "ell", "--device", "cpu"])
    assert isinstance(worker.build_model_and_adj(args, load_graph("none"))[1], EllAdj)
    args = worker.build_parser().parse_args(["--model", "dmp", "--device", "cpu"])
    with pytest.raises(ValueError, match="trainable"):
        worker.build_model(args, 10)


@pytest.mark.parametrize("family", ["GCN", "GIN"])
def test_gnn_baselines_serve_from_a_checkpoint(family, tmp_path):
    """A JAX GCN/GIN tree carried across, saved, and scored by ``infer.main``:
    equal to the port's ``model.predict`` (1e-6) and to the JAX serving path
    on the same params (1e-5)."""
    argv = ["--ckpt", str(tmp_path), "--dataset", "none", "--model", family, "--hidden", "8",
            "--maxTime", "6"]
    jargs = jax_infer.build_parser().parse_args([*argv, "--I_indices", "x"])
    jg = jax_load_graph("none")
    jmodel, jadj = jax_worker.build_model_and_adj(jargs, jg, batch_size=3)
    pj = jmodel.init(jax.random.PRNGKey(5))
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    save_params(str(tmp_path), pt)
    out = tmp_path / "p.npz"
    assert infer.main([*argv, "--device", "cpu", *SCEN, "--out", str(out)]) == 0
    z = np.load(out, allow_pickle=True)
    got = np.stack([z["S"], z["I"], z["R"]], -1)  # [B, T, n, 3]
    g = load_graph("none")
    args = infer.build_parser().parse_args([*argv, "--device", "cpu"])
    model, adj = worker.build_model_and_adj(args, g, batch_size=3)
    infer.check_params_match(model, pt)
    sb = infer.scenario_batch(g.n_nodes, SEEDS, BETA, GAMMA)
    direct = model.predict(pt, adj, *map(torch.as_tensor, sb)).permute(1, 0, 2, 3).numpy()
    assert got.shape == (3, 6, g.n_nodes, 3)
    np.testing.assert_allclose(got, direct, atol=1e-6)
    want = jax_infer.predict_scenarios(jmodel, pj, jadj, *sb)
    np.testing.assert_allclose(got, np.transpose(np.asarray(want), (1, 0, 2, 3)), atol=ATOL)
    chunked = infer.predict_summaries(model, pt, adj, *sb, dispatch_batch=2)
    whole = infer.predict_summaries(model, pt, adj, *sb)
    if family == "GCN":  # GIN's batch norm reads the whole dispatch: chunking changes it
        _assert_rows_close([{k: str(v) for k, v in r.items()} for r in chunked],
                           [{k: str(v) for k, v in r.items()} for r in whole])
    with pytest.raises(SystemExit, match="do not match"):
        infer.main([*argv[:-4], "--hidden", "4", "--maxTime", "6", "--device", "cpu", *SCEN])


def test_params_checkpoint_roundtrip(served, tmp_path):
    ckpt, params = served
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = restore_params(ckpt, device="cpu")
    back = params_to_numpy(port)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    path = save_params(str(tmp_path), port, name="other")
    assert path.endswith("other.pt")
    again = restore_params(str(tmp_path), name="other", device="cpu")
    torch.testing.assert_close(again["func"]["w"], port["func"]["w"], rtol=0, atol=0)
    # the port's params serve the JAX model too (numpy leaves)
    from gn_ode_sir_tpu.models.gnode import GNODE as JaxGNODE

    jax_infer.check_params_match(JaxGNODE(hidden=8, max_time=8), back)


def test_check_params_match_rejects_wrong_structure(served):
    from gn_ode_sir_tpu_torch.models.gnode import GNODE

    ckpt, _ = served
    p = restore_params(ckpt, device="cpu")
    infer.check_params_match(GNODE(hidden=8), p)
    with pytest.raises(SystemExit):
        infer.check_params_match(GNODE(hidden=8), {**p, "extra": torch.zeros(1)})
    with pytest.raises(SystemExit):
        infer.check_params_match(GNODE(hidden=8), [p])


def test_summary_reduce_matches_jax_incl_ties_and_mask():
    """First maximum on ties (as jnp.argmax), and the masked node means."""
    from gn_ode_sir_tpu.cli.infer import _summary_reduce as jax_reduce

    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(3), size=(6, 2, 5)).astype(np.float32)  # [T, B, n, 3]
    probs[3:, 0] = probs[2, 0]  # scenario 0 plateaus: its peak repeats from t=2 on
    mask = np.ones((2, 5), np.float32)
    mask[1, 3:] = 0.0
    for m in (None, mask):
        got = infer._summary_reduce(torch.as_tensor(probs),
                                    None if m is None else torch.as_tensor(m)).numpy()
        want = np.asarray(jax_reduce(probs, m))
        np.testing.assert_allclose(got, want, atol=1e-6)
    flat = np.full((4, 1, 3, 3), 1 / 3, np.float32)
    assert infer._summary_reduce(torch.as_tensor(flat))[0, 1] == 0


def test_scenarios_and_parsers_match_jax(tmp_path):
    spec = [{"seeds": [1, 2], "beta": 0.3, "gamma": 0.1}, {"seeds": [4], "beta": 0.2, "gamma": 0.5}]
    path = tmp_path / "scen.json"
    path.write_text(json.dumps(spec))
    for argv in (["--scenarios", str(path)], SCEN, ["--I_indices", "3,4", "[5]"]):
        full = ["--ckpt", "x", "--dataset", "none", *argv]
        got = infer.load_scenarios(infer.build_parser().parse_args(full))
        want = jax_infer.load_scenarios(jax_infer.build_parser().parse_args(full))
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        for a, b in zip(infer.scenario_batch(10, *got), jax_infer.scenario_batch(10, *want)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit):
        infer.load_scenarios(infer.build_parser().parse_args(
            ["--ckpt", "x", "--dataset", "none", "--I_indices", "1", "2", "--beta", "0.1"]))
    # same flags and defaults as the JAX parsers, plus --device
    for port_p, jax_p in ((worker.build_parser(), jax_worker.build_parser()),
                          (infer.build_parser(), jax_infer.build_parser())):
        pd = {a.dest: a.default for a in port_p._actions}
        jd = {a.dest: a.default for a in jax_p._actions}
        assert set(pd) - set(jd) == {"device"} and set(jd) <= set(pd)
        assert all(pd[k] == jd[k] for k in jd if k != "help")
        assert pd["device"] == "cuda"


def test_constructors_need_an_explicit_device(served):
    """Nothing that places tensors picks a device for the caller: without
    ``device`` each constructor and loader refuses to run."""
    from gn_ode_sir_tpu_torch.graphs.graph import Graph
    from gn_ode_sir_tpu_torch.models.gnode import GNODE
    from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
    from gn_ode_sir_tpu_torch.ops.spmm2 import CsrPlan, Spmm2Adj

    ckpt, params = served
    g = Graph(n_nodes=3, src=np.array([1, 0]), dst=np.array([0, 1]))
    calls = [
        lambda **kw: adjacency_from_graph(g, **kw),
        lambda **kw: CsrPlan.build(g.src, g.dst, g.n_nodes, **kw),
        lambda **kw: Spmm2Adj.from_graph(g, **kw),
        lambda **kw: GNODE(hidden=8).init(torch.Generator(), **kw),
        lambda **kw: restore_params(ckpt, **kw),
        lambda **kw: infer.restore_params(ckpt, **kw),
        lambda **kw: params_from_numpy(jax.tree_util.tree_map(np.asarray, params), **kw),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="device"):
            call()
        call(device="cpu")
