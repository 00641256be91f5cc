"""Port parity: the experiment worker (gn_ode_sir_tpu_torch.cli.worker) end to
end on the CPU with ``--dataset none`` against the JAX worker: the CSV header
and row layout, the ``initial-*.pkl`` contents, the two out-of-dist CSVs, the
saved checkpoint served through ``cli.infer``, the baselines (``--model
dmp|rk|GCN|GIN``, ``--rk_baseline``), ``+``-joined multi-graph datasets, and
the flags of the experiment matrix (``--ensemble``, ``--node_split``,
checkpoints, resume and the crash drill). Labels come from different random streams
in the two packages and the models from different initial params, so trained
losses are compared for layout and type, not value (``test_torch_fit.py``
and ``test_torch_multigraph.py`` hold the training itself against JAX from
equal params); what has no trained params — the DMP and RK losses — is
compared in value, the JAX worker fed the label pickles the port wrote."""

import csv
import json
import os
import pickle
import shutil

import networkx as nx
import numpy as np
import pytest
import torch

from gn_ode_sir_tpu.cli import worker as jax_worker
from gn_ode_sir_tpu_torch.cli import infer, worker
from gn_ode_sir_tpu_torch.graphs.graph import graph_from_edges
from gn_ode_sir_tpu_torch.utils.config import ExperimentConfig
from gn_ode_sir_tpu_torch.utils.csvsink import TRIAL_COLUMNS, csv_trials

torch.set_num_threads(1)

SEEDS = ["[1, 2]", "[3]", "[4, 5]", "[6]", "[7, 8]", "[9]", "[10, 11]", "[12]"]
BETA = ["0.2", "0.3", "0.4", "0.25", "0.35", "0.45", "0.15", "0.5"]
GAMMA = ["0.1", "0.2", "0.3", "0.15", "0.25", "0.35", "0.4", "0.05"]


def _argv(path, *extra):
    return ["--dataset", "none", "--model", "ode_nn", "--epochs", "2", "--hidden", "8",
            "--maxTime", "5", "--sim", "100", "--batch_size", "2", "--lr", "1e-3",
            "--I_indices", *SEEDS, "--beta", *BETA, "--gamma", *GAMMA,
            "--path_to_save", str(path), "--trial", "3", *extra]


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture
def no_jax_side_effects(monkeypatch):
    monkeypatch.setenv("GN_JAX_CACHE", "0")  # no compile cache outside tmp_path


def test_worker_csv_and_pickles_match_the_jax_worker(tmp_path, no_jax_side_effects):
    jd, td = tmp_path / "jax", tmp_path / "torch"
    assert jax_worker.main(_argv(jd, "--auto_checkpoint", "0")) == 0
    assert worker.main(_argv(td, "--device", "cpu")) == 0
    jrows = _read_csv(jd / "Metrics-trials-gnp50")
    trows = _read_csv(td / "Metrics-trials-gnp50")
    assert trows[0] == jrows[0] == TRIAL_COLUMNS and len(TRIAL_COLUMNS) == 18
    assert len(trows) == len(jrows) == 2 and len(trows[1]) == len(jrows[1]) == 18
    assert trows[1][:12] == jrows[1][:12]  # the run's configuration columns
    assert trows[1][0] == "3" and trows[1][10] == "[2, 8]"
    for col in range(12, 18):  # best_epoch, losses, times: numbers in both
        float(trows[1][col]), float(jrows[1][col])
    assert 0 <= int(trows[1][12]) < 2 and 0 < float(trows[1][14]) < 1
    assert trows[1][15] == jrows[1][15] == "0.0" and trows[1][17] == "0.0"
    for name in ("initial-seed.pkl", "initial-beta.pkl", "initial-gamma.pkl"):
        with open(jd / name, "rb") as a, open(td / name, "rb") as b:
            assert pickle.load(a) == pickle.load(b)
    # the same label file names (contents differ: other random streams)
    pk = lambda d: sorted(f for f in os.listdir(d) if f.startswith("gnp50-"))
    assert pk(td) == pk(jd) and len(pk(td)) == 24
    # a second port run appends a row and simulates nothing
    mtime = os.path.getmtime(td / pk(td)[0])
    assert worker.main(_argv(td, "--device", "cpu", "--init_seed", "4")) == 0
    assert len(_read_csv(td / "Metrics-trials-gnp50")) == 3
    assert os.path.getmtime(td / pk(td)[0]) == mtime


def test_worker_out_of_dist_writes_its_two_csvs(tmp_path, no_jax_side_effects):
    jd, td = tmp_path / "jax", tmp_path / "torch"
    assert jax_worker.main(_argv(jd, "--out_of_dist", "--auto_checkpoint", "0")) == 0
    assert worker.main(_argv(td, "--out_of_dist", "--device", "cpu")) == 0
    for name in ("Out-of-dist-gamma-gnp50", "Out-of-dist-gamma-trials-gnp50"):
        jrows, trows = _read_csv(jd / name), _read_csv(td / name)
        assert trows[0] == jrows[0] and len(trows) == 2
        assert len(trows[1]) == len(jrows[1]) == len(trows[0])
    per_trial = _read_csv(td / "Out-of-dist-gamma-gnp50")
    assert all(0 < float(x) < 1 for x in per_trial[1])
    summary = _read_csv(td / "Out-of-dist-gamma-trials-gnp50")
    assert summary[1][:7] == _read_csv(jd / "Out-of-dist-gamma-trials-gnp50")[1][:7]
    assert not os.path.exists(td / "Metrics-trials-gnp50")
    with open(jd / "out-of-dist-gamma.pkl", "rb") as a, \
            open(td / "out-of-dist-gamma.pkl", "rb") as b:
        dj, dt = pickle.load(a), pickle.load(b)
    assert dt["train"] == dj["train"] and dt["test"] == dj["test"]


def test_saved_checkpoint_serves_through_cli_infer(tmp_path):
    assert worker.main(_argv(tmp_path, "--device", "cpu", "--save_checkpoint")) == 0
    ckpt = worker.checkpoint_dir_for(str(tmp_path), 3, "ode_nn", "none")
    assert os.path.isfile(os.path.join(ckpt, "serve.pt"))
    out = tmp_path / "p.npz"
    rc = infer.main(["--device", "cpu", "--ckpt", ckpt, "--dataset", "none", "--hidden", "8",
                     "--maxTime", "5", "--I_indices", "[2, 5]", "[7]", "--beta", "0.3", "0.2",
                     "--gamma", "0.1", "0.4", "--out", str(out)])
    assert rc == 0
    z = np.load(out, allow_pickle=True)
    assert z["I"].shape == (2, 5, 50)
    np.testing.assert_allclose(z["S"] + z["I"] + z["R"], 1.0, atol=1e-5)


def test_worker_takes_a_graph_and_a_config_file(tmp_path):
    """``main(argv, graph)`` runs on a handed-in graph (no networkx), and
    ``--config`` fields become flag defaults that explicit flags override."""
    g = graph_from_edges(12, [(k, (k + 1) % 12) for k in range(12)] + [(0, 6)], name="ring")
    cfg = ExperimentConfig(
        model="ode_nn", hidden=4, lr=1e-3, epochs=1, batch_size=2, delta_t=0.5, max_time=4,
        sim=50, dataset="unused", path_to_save=str(tmp_path),
        i_indices=[[1], [2, 3], [4], [5], [6]], beta=[0.2] * 5, gamma=[0.1] * 5)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    assert ExperimentConfig.from_json(cfg.to_json()).i_indices == [[1], [2, 3], [4], [5], [6]]
    assert worker.main(["--config", str(cfg_path), "--device", "cpu", "--epochs", "2"],
                       graph=g) == 0
    rows = _read_csv(tmp_path / "Metrics-trials-ring")
    assert rows[1][3] == "2" and rows[1][11] == "4" and rows[1][10] == "[1, 5]"
    assert os.path.exists(tmp_path / "ring-S-2-3-b0.2-g0.1.pkl")


def _two_graphs():
    import networkx as nx

    from gn_ode_sir_tpu_torch.graphs.graph import graph_from_networkx

    ga = graph_from_networkx(nx.karate_club_graph(), name="karate")
    gb = graph_from_networkx(nx.connected_watts_strogatz_graph(40, 4, 0.2, seed=1),
                             name="dolphins")
    return [ga, gb]


@pytest.mark.parametrize("extra,item", [
    (["--ensemble", "2"], "train/ensemble.py"),
    (["--node_split"], "train/node_split.py"),
    (["--resume"], "resume in fit"),
    (["--checkpoint_every", "5"], "resume in fit"),
    (["--die_at_epoch", "1"], "resume in fit"),
    (["--auto_checkpoint", "0"], "resume in fit"),
    (["--dataset", "karate+dolphins", "--ensemble", "2"], "train/ensemble.py"),
    (["--dataset", "karate+dolphins", "--resume"], "resume in fit"),
    (["--model", "GCN", "--node_split"], "train/node_split.py"),
])
def test_unported_flags_raise_naming_their_item(tmp_path, extra, item):
    """The flags that were refused before the matrix slice (``item``: what
    ports each) now run on a tiny graph and write their CSV row(s): an
    ensemble one per member (trials 3 and 4), the crash drill exits with 17
    and its --resume completes, a requested checkpoint lands in the run's
    directory."""
    rows = 2 if item == "train/ensemble.py" else 1
    multi = "karate+dolphins" in extra
    argv = _argv(tmp_path, "--device", "cpu", *extra)
    if multi:
        argv += ["--instances_per_graph", "4", "4"]
    graph = _two_graphs() if multi else None
    if "--die_at_epoch" in extra:
        argv += ["--checkpoint_every", "1"]
        with pytest.raises(SystemExit) as exc:
            worker.main(argv, graph=graph)
        assert exc.value.code == 17
        assert not os.path.exists(tmp_path / "Metrics-trials-gnp50")
        argv += ["--resume"]
    assert worker.main(argv, graph=graph) == 0
    name = "karate+dolphins" if multi else "gnp50"
    table = _read_csv(tmp_path / f"Metrics-trials-{name}")
    assert [r[0] for r in table[1:]] == [str(3 + j) for j in range(rows)]
    assert all(0.0 < float(r[14]) < 1.0 for r in table[1:])
    ens = 2 if "--ensemble" in extra else 0
    ckpt = worker.checkpoint_dir_for(str(tmp_path), 3, "GCN" if "GCN" in extra else "ode_nn",
                                     name, ensemble=ens)
    saved = any(f in extra for f in ("--checkpoint_every", "--die_at_epoch"))
    assert os.path.exists(os.path.join(ckpt, "state.pt")) == saved


@pytest.mark.parametrize("extra", [["--node_split"], ["--model", "dmp"], ["--model", "rk"]])
def test_ensemble_refusals_equal_the_jax_worker(tmp_path, no_jax_side_effects, extra):
    """--ensemble with the node split or an untrained baseline is refused
    with the JAX worker's message, before any label is simulated."""
    with pytest.raises(SystemExit) as want:
        jax_worker.main(_argv(tmp_path / "jax", "--ensemble", "2", *extra))
    with pytest.raises(SystemExit) as got:
        worker.main(_argv(tmp_path / "torch", "--device", "cpu", "--ensemble", "2", *extra))
    assert str(got.value) == str(want.value) and "--ensemble" in str(got.value)
    assert not os.path.exists(tmp_path / "torch")


def _copy_pickles(src_dir, dst_dir):
    """Hand the label and trial-parameter pickles of one run to another."""
    for root, _, files in os.walk(src_dir):
        into = os.path.join(dst_dir, os.path.relpath(root, src_dir))
        os.makedirs(into, exist_ok=True)
        for f in files:
            if f.endswith(".pkl"):
                shutil.copy(os.path.join(root, f), into)


@pytest.mark.parametrize("model", ["dmp", "rk"])
def test_closed_form_baselines_match_the_jax_worker(tmp_path, no_jax_side_effects, model):
    jd, td = tmp_path / "jax", tmp_path / "torch"
    assert worker.main(_argv(td, "--device", "cpu", "--model", model)) == 0
    _copy_pickles(td, jd)
    assert jax_worker.main(_argv(jd, "--model", model)) == 0
    jrow, trow = _read_csv(jd / "Metrics-trials-gnp50"), _read_csv(td / "Metrics-trials-gnp50")
    assert trow[0] == jrow[0] == TRIAL_COLUMNS and len(trow) == len(jrow) == 2
    assert trow[1][:14] == jrow[1][:14] and trow[1][1] == model  # best_epoch 0, val_loss 0.0
    assert float(trow[1][14]) == pytest.approx(float(jrow[1][14]), abs=1e-5)  # test_loss
    assert 0 < float(trow[1][14]) < 0.5 and float(trow[1][16]) > 0
    if model == "rk":  # the RK row repeats its loss and time in the baseline columns
        assert trow[1][15] == trow[1][14] and trow[1][17] == trow[1][16]
    else:
        assert trow[1][15] == trow[1][17] == "0.0"


@pytest.mark.parametrize("model", ["GCN", "GIN"])
def test_gnn_baselines_train_and_serve(tmp_path, no_jax_side_effects, model):
    jd, td = tmp_path / "jax", tmp_path / "torch"
    extra = ("--model", model, "--rk_baseline")
    assert worker.main(_argv(td, "--device", "cpu", "--save_checkpoint", *extra)) == 0
    _copy_pickles(td, jd)
    assert jax_worker.main(_argv(jd, "--auto_checkpoint", "0", *extra)) == 0
    jrow, trow = _read_csv(jd / "Metrics-trials-gnp50"), _read_csv(td / "Metrics-trials-gnp50")
    assert trow[0] == jrow[0] and trow[1][:12] == jrow[1][:12] and trow[1][1] == model
    assert 0 <= int(trow[1][12]) < 2 and 0 < float(trow[1][14]) < 1
    # --rk_baseline fills loss_baseline and rk_time, with the JAX worker's value
    assert float(trow[1][15]) == pytest.approx(float(jrow[1][15]), abs=1e-5)
    assert 0 < float(trow[1][15]) < 0.5 and float(trow[1][17]) > 0
    ckpt = worker.checkpoint_dir_for(str(td), 3, model, "none")
    out = tmp_path / "p.npz"
    assert infer.main(["--device", "cpu", "--ckpt", ckpt, "--dataset", "none", "--model", model,
                       "--hidden", "8", "--maxTime", "5", "--I_indices", "[2, 5]", "[7]",
                       "--beta", "0.3", "0.2", "--gamma", "0.1", "0.4", "--out", str(out)]) == 0
    z = np.load(out, allow_pickle=True)
    assert z["I"].shape == (2, 5, 50)
    np.testing.assert_allclose(z["S"] + z["I"] + z["R"], 1.0, atol=1e-5)


def _mg_argv(path, dataset, *extra):
    return ["--dataset", dataset, "--model", "ode_nn", "--epochs", "2", "--hidden", "8",
            "--maxTime", "5", "--sim", "100", "--batch_size", "2", "--lr", "1e-3",
            "--instances_per_graph", "4", "4", "--path_to_save", str(path), "--trial", "2",
            "--rk_baseline", *extra]


@pytest.fixture
def two_graph_dataset(tmp_path):
    """``<dir>/ring+wheel``: two networkx pickles, as a '+'-joined dataset."""
    d = tmp_path / "graphs"
    d.mkdir()
    for name, G in (("ring", nx.circular_ladder_graph(9)), ("wheel", nx.wheel_graph(25))):
        with open(d / f"{name}.pkl", "wb") as f:
            pickle.dump(G, f)
    return str(d / "ring+wheel")


@pytest.mark.parametrize("mg_adj", ["dense", "pallas2"])
def test_multigraph_worker_matches_the_jax_worker(tmp_path, no_jax_side_effects,
                                                  two_graph_dataset, mg_adj):
    jd, td = tmp_path / "jax", tmp_path / "torch"
    argv = lambda d, *extra: _mg_argv(d, two_graph_dataset, "--mg_adj", mg_adj, *extra)
    assert worker.main(argv(td, "--device", "cpu", "--save_checkpoint")) == 0
    _copy_pickles(td, jd)
    assert jax_worker.main(argv(jd, "--auto_checkpoint", "0")) == 0
    name = "Metrics-trials-ring+wheel"
    jrow, trow = _read_csv(jd / name), _read_csv(td / name)
    assert trow[0] == jrow[0] == TRIAL_COLUMNS and len(trow) == len(jrow) == 2
    assert trow[1][:12] == jrow[1][:12] and trow[1][0] == "2" and trow[1][10] == "[0, 0]"
    assert 0 <= int(trow[1][12]) < 2 and 0 < float(trow[1][14]) < 1
    assert float(trow[1][15]) == pytest.approx(float(jrow[1][15]), abs=1e-5)  # RK on the wheel
    assert float(trow[1][17]) > 0
    # per-graph trial parameters and labels under Experiments-seed2-<name>
    for g, n_nodes in (("ring", 18), ("wheel", 25)):
        sub = td / f"Experiments-seed2-{g}"
        with open(sub / "initial-seed.pkl", "rb") as f:
            seeds = pickle.load(f)
        assert len(seeds) == 4 and all(len(s) == 2 and max(s) < n_nodes for s in seeds)
        assert len([f for f in os.listdir(sub) if f.startswith(f"{g}-S-")]) == 4
    # a second run reuses the pinned trials and the labels, and appends its row
    label = next(f for f in os.listdir(td / "Experiments-seed2-wheel") if f.startswith("wheel-I-"))
    mtime = os.path.getmtime(td / "Experiments-seed2-wheel" / label)
    assert worker.main(argv(td, "--device", "cpu", "--init_seed", "3")) == 0
    assert len(_read_csv(td / name)) == 3
    assert os.path.getmtime(td / "Experiments-seed2-wheel" / label) == mtime
    # the graph-agnostic checkpoint, under the directory that names the graphs, serves
    ckpt = worker.checkpoint_dir_for(str(td), 2, "ode_nn", two_graph_dataset)
    assert ckpt.endswith("ckpt-trial2-ode_nn-mg-ring-wheel")
    assert ckpt == jax_worker.checkpoint_dir_for(str(td), 2, "ode_nn", two_graph_dataset)
    out = tmp_path / "p.npz"
    assert infer.main(["--device", "cpu", "--ckpt", ckpt, "--dataset", "none", "--hidden", "8",
                       "--maxTime", "5", "--I_indices", "[2, 5]", "--out", str(out)]) == 0
    assert np.load(out, allow_pickle=True)["I"].shape == (1, 5, 50)


@pytest.mark.parametrize("mg_adj", ["auto", "coo"])
def test_multigraph_worker_takes_graphs_and_flat_trials(tmp_path, mg_adj, capsys):
    """``main(argv, graph=[...])`` runs on handed-in graphs, with the trials
    given flat on the command line, for a GCN."""
    ga = graph_from_edges(12, [(k, (k + 1) % 12) for k in range(12)], name="a")
    gb = graph_from_edges(20, [(0, k) for k in range(1, 20)], name="b")
    argv = _argv(tmp_path, "--device", "cpu", "--model", "GCN", "--mg_adj", mg_adj,
                 "--instances_per_graph", "4", "4")
    argv[argv.index("--dataset") + 1] = "a+b"
    assert worker.main(argv, graph=[ga, gb]) == 0
    rows = _read_csv(tmp_path / "Metrics-trials-a+b")
    assert rows[1][1] == "GCN" and rows[1][10] == "[2, 8]" and rows[1][15] == "0.0"
    printed = capsys.readouterr().out
    assert f"multigraph adjacency backend: {'dense' if mg_adj == 'auto' else 'coo'}" in printed
    assert "padded to n=24, e=128" in printed and "unseen graph b" in printed
    assert os.path.exists(tmp_path / "Experiments-seed2-a" / "a-S-1-2-b0.2-g0.1.pkl")
    assert not os.path.exists(tmp_path / "Experiments-seed2-a" / "initial-seed.pkl")


@pytest.mark.parametrize("extra,message", [
    (["--out_of_dist"], "single-graph protocol"),
    (["--model", "dmp"], "single-graph only"),
    (["--model", "rk"], "single-graph only"),
    (["--instances_per_graph", "4"], "one count per graph"),
    (["--I_indices", "[1]", "[2]", "--beta", "0.2", "--gamma", "0.1", "0.2"], "must align"),
    (["--I_indices", "[1]", "--beta", "0.2", "--gamma", "0.1"], "sums to 8"),
])
def test_multigraph_worker_exits_as_the_jax_worker_does(tmp_path, no_jax_side_effects,
                                                        two_graph_dataset, extra, message):
    for main, device in ((worker.main, ["--device", "cpu"]), (jax_worker.main, [])):
        with pytest.raises(SystemExit, match=message):
            main(_mg_argv(tmp_path, two_graph_dataset, *device, *extra))


def test_worker_refuses_misaligned_trials_and_missing_card(tmp_path):
    argv = _argv(tmp_path, "--device", "cpu")
    argv[argv.index("--beta") + 1:argv.index("--gamma")] = ["0.2"]
    with pytest.raises(SystemExit, match="must align"):
        worker.main(argv)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cuda"):
            worker.main(_argv(tmp_path))  # the default device is the card


def test_csv_sink_prints_the_table_without_pandas(tmp_path, capsys):
    path = str(tmp_path / "sub" / "Metrics")
    csv_trials(path, ["a", "bb"], [1, "x,y"])
    csv_trials(path, ["a", "bb"], [22, 0.5], print_table=True)
    out = capsys.readouterr().out.splitlines()
    assert out[-3].split() == ["a", "bb"] and out[-1].split() == ["22", "0.5"]
    assert _read_csv(path) == [["a", "bb"], ["1", "x,y"], ["22", "0.5"]]
    csv_trials(path, ["a", "bb"], [3, 4], print_table=False)
    assert capsys.readouterr().out == ""
    assert json.loads(ExperimentConfig().to_json())["coins"] == "auto"
