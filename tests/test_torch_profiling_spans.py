"""The port's phase spans (``utils.profiling.span``) on the CPU.

Off (no profiler) a span is one shared no-op: it makes no
``record_function`` and the paths' outputs are those of the same arithmetic
without spans, bit for bit. Under ``torch.profiler`` each training step,
serving dispatch and label chunk shows its phases as top-level host events,
and the outputs do not change. The file imports no JAX.
"""

import contextlib
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gn_ode_sir_tpu_torch.cli import infer
from gn_ode_sir_tpu_torch.graphs import graph_from_edges
from gn_ode_sir_tpu_torch.models import GNODE
from gn_ode_sir_tpu_torch.ops.adjacency import adjacency_from_graph
from gn_ode_sir_tpu_torch.sim import mc_sir
from gn_ode_sir_tpu_torch.train import build_trial_data, fit
from gn_ode_sir_tpu_torch.train.checkpoint import tree_leaves, tree_map
from gn_ode_sir_tpu_torch.train.loop import _batch_loss, _data_to_device, make_train_epoch_fn
from gn_ode_sir_tpu_torch.utils import profiling

torch.set_num_threads(1)

TRAIN = ("train.forward", "train.backward", "train.optimizer")
SERVE = ("serve.upload", "serve.forward", "serve.readback")
LABELS = ("labels.prepare", "labels.steps", "labels.readback", "labels.unpack",
          "labels.probs")
N, MAX_TIME, TRIALS = 12, 4, 6
ROWS = np.array([[0, 1], [2, 3], [4, 5]])


def _graph():
    return graph_from_edges(N, [(k, (k + 1) % N) for k in range(N)] + [(0, 6), (3, 9)])


def _setup():
    """(model, adjacency, start params, device data) of a small GN-ODE."""
    rng = np.random.default_rng(0)
    triples = []
    for _ in range(TRIALS):
        p = rng.dirichlet([2.0, 1.0, 1.0], size=(MAX_TIME, N))
        triples.append((p[..., 0], p[..., 1], p[..., 2]))
    data = build_trial_data(N, [[int(rng.integers(N))] for _ in range(TRIALS)],
                            rng.uniform(0.1, 0.5, TRIALS), rng.uniform(0.1, 0.4, TRIALS),
                            triples)
    model = GNODE(hidden=4, max_time=MAX_TIME)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    adj = adjacency_from_graph(_graph(), kind="dense", device="cpu")
    return model, adj, params, _data_to_device(data, "cpu")


def _trained(setup):
    """A fresh trained copy of the start params and its Adam."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), setup[2])
    return params, torch.optim.Adam([leaf for _, leaf in tree_leaves(params)], lr=1e-2)


def _epoch(setup):
    """One call of the epoch function over ``ROWS``: (loss, params)."""
    model, adj, _, d = setup
    params, opt = _trained(setup)
    fn = make_train_epoch_fn(model, opt, lambda gi: adj)
    loss = fn(params, d, ROWS, np.ones(ROWS.shape, np.float32))
    return loss, params


def _events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _counts(events, names):
    """Per name, its top-level events; and the number of its nested ones."""
    top = {n: sum(1 for e in events if e.name == n and e.cpu_parent is None) for n in names}
    nested = sum(1 for e in events if e.name in names and e.cpu_parent is not None)
    return top, nested


def _same(a, b):
    assert len(a) == len(b)
    for (pa, ta), (pb, tb) in zip(tree_leaves(a), tree_leaves(b)):
        assert pa == pb and torch.equal(ta, tb), pa


def _serve(setup, scenarios=5, dispatch_batch=2):
    model, adj, params, _ = setup
    rng = np.random.default_rng(1)
    arrays = infer.scenario_batch(N, [[int(k)] for k in rng.integers(N, size=scenarios)],
                                  rng.uniform(0.1, 0.5, scenarios),
                                  rng.uniform(0.1, 0.4, scenarios))
    return infer.predict_summaries(model, params, adj, *arrays, dispatch_batch=dispatch_batch)


def _labels():
    trials = [([1], 0.3, 0.2), ([4, 7], 0.4, 0.1), ([2], 0.2, 0.3), ([9], 0.5, 0.2)]
    return mc_sir.simulate_sir_many(_graph(), trials, sims=32, max_time=5,
                                    seeds=[11, 12, 13, 14], trials_chunk=2, device="cpu")


def test_span_off_makes_no_record_and_changes_no_output(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("train.forward") is profiling.span("serve.upload")

    def refuse(*args, **kwargs):
        raise AssertionError("a span made a record_function with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    setup = _setup()
    loss, params = _epoch(setup)
    # the same steps written out without spans
    model, adj, _, d = setup
    want, opt = _trained(setup)
    loss_sum, item_sum = torch.zeros(()), torch.zeros(())
    for row in ROWS:
        opt.zero_grad(set_to_none=True)
        step_loss, items = _batch_loss(model, want, lambda gi: adj, None, d,
                                       torch.as_tensor(row), torch.ones(len(row)),
                                       d["graph_idx"][row], train=True)
        step_loss.backward()
        opt.step()
        loss_sum += step_loss.detach() * items
        item_sum += items
    assert torch.equal(loss, loss_sum / item_sum)
    _same(params, want)
    _serve(setup)
    _labels()


def test_training_step_spans_are_top_level_and_change_nothing():
    setup = _setup()
    (loss, params), events = _events(lambda: _epoch(setup))
    top, nested = _counts(events, TRAIN)
    assert top == {n: len(ROWS) for n in TRAIN} and nested == 0
    want_loss, want = _epoch(setup)
    assert torch.equal(loss, want_loss)
    _same(params, want)


def test_each_step_enters_its_phases_by_name_in_order(monkeypatch):
    """With a profiler on, every optimiser step makes exactly one range of
    each phase, in the step's order, named and nothing more."""
    got = []
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *args: got.append(args) or contextlib.nullcontext())
    model, adj, _, d = setup = _setup()
    params, opt = _trained(setup)
    fn = make_train_epoch_fn(model, opt, lambda gi: adj)
    for rows in (ROWS[:2], ROWS[2:]):
        fn(params, d, rows, np.ones(rows.shape, np.float32))
    assert got == [(n,) for _ in range(len(ROWS)) for n in TRAIN]


def test_serving_spans_per_dispatch_and_upload_bytes():
    setup = _setup()
    before = (infer._upload.upload_bytes, infer._upload.calls)
    rows, events = _events(lambda: _serve(setup))
    chunks = 3  # 5 scenarios in dispatches of 2, the last padded
    top, nested = _counts(events, SERVE)
    assert top == {n: chunks for n in SERVE} and nested == 0
    per_chunk = sum(a.nbytes for a in infer.scenario_batch(N, [[0], [1]], [0.1, 0.2],
                                                           [0.1, 0.2]))
    assert per_chunk == 3 * 2 * N * 4 + 2 * 2 * 4
    assert (infer._upload.upload_bytes - before[0], infer._upload.calls - before[1]) == (
        chunks * per_chunk, chunks)
    assert rows == _serve(setup)


def test_label_spans_per_chunk_and_same_sums():
    got, events = _events(_labels)
    top, nested = _counts(events, LABELS)
    # the first four once a chunk, the float64 division once a call
    assert top == {n: 2 for n in LABELS[:4]} | {"labels.probs": 1} and nested == 0
    want = _labels()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_fit_profile_dir_trace_carries_the_spans(tmp_path):
    model, adj, params, _ = _setup()
    rng = np.random.default_rng(0)
    triples = [tuple(np.moveaxis(rng.dirichlet([2.0, 1.0, 1.0], size=(MAX_TIME, N)), -1, 0))
               for _ in range(4)]
    data = build_trial_data(N, [[1], [2], [3], [4]], [0.2, 0.3, 0.4, 0.25],
                            [0.1, 0.2, 0.3, 0.15], triples)
    d = str(tmp_path / "prof")
    fit(model, lambda leaves: torch.optim.Adam(leaves, lr=1e-2), params, data, [0, 1], [2],
        [3], lambda gi: adj, epochs=3, batch_size=1, seed=1, verbose=False, profile_dir=d,
        profile_epochs=(1, 1))
    (path,) = glob.glob(os.path.join(d, "*.pt.trace.json"))
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    # epoch 1 alone: two steps of one trial each
    assert [names.count(n) for n in TRAIN] == [2, 2, 2]


def test_a_span_is_one_range_around_its_work():
    def work():
        with profiling.span("serve.upload"):
            torch.ones(2).sum()

    _, events = _events(work)
    (top,) = [e for e in events if e.cpu_parent is None]
    assert top.name == "serve.upload"
    assert {e.name for e in events if e.cpu_parent is top} == {"aten::ones", "aten::sum"}
