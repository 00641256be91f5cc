"""The readers of the program's spans: each on a hand-made trace, None
without its spans, the interval arithmetic of ``chunk_idle_ms`` at its
edges, and every span-reader on a real CPU profile of its cell's path."""

import time
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from perfbench import harness, profiling, spans
from perfbench.tests import small

BENCH = harness.load_benchmark()
# the span readers of each cell, as its driver declares them
READERS = {c["name"]: list(getattr(driver, "SPAN_METRICS", ()))
           for c in BENCH["workloads"]
           for driver in [harness.load_module("drivers", harness.load_workload(c["name"])["driver"])]}
READERS = {c: names for c, names in READERS.items() if names}


def _run(host=(), device=(), traced=None, **extra):
    trace = profiling.Trace(sorted(device, key=lambda s: s[1]),
                            sorted(host, key=lambda s: s[1]), wall_s=1.0)
    return SimpleNamespace(trace=trace, traced=traced, **extra)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_training_phases_per_step():
    host = [("train.forward", 0, 3000), ("train.backward", 3000, 8000),
            ("train.optimizer", 8000, 9000), ("Optimizer.zero_grad#Adam.zero_grad", 9000, 9100),
            ("train.forward", 10000, 12000), ("train.backward", 12000, 16000),
            ("train.optimizer", 16000, 16500)]
    run = _run(host, traced={"steps": 2})
    assert _read("forward_host_ms.train", run) == pytest.approx(2.5)
    assert _read("backward_host_ms.train", run) == pytest.approx(4.5)
    assert _read("optimizer_host_ms.train", run) == pytest.approx(0.75)


def test_serving_phases_per_request():
    host = [("serve.upload", 0, 1000), ("serve.forward", 1000, 6000),
            ("serve.readback", 6000, 60000), ("aten::to", 60000, 60100)]
    run = _run(host, traced={"requests": 1})
    assert _read("forward_ms.serve", run) == pytest.approx(6.0)
    assert _read("readback_wait_ms.serve", run) == pytest.approx(54.0)


@pytest.mark.parametrize("name", list(dict.fromkeys(m for ms in READERS.values() for m in ms)))
def test_none_without_its_spans(name):
    """A program without the spans (or a stretch without a trace, or with
    no unit) gives None, never 0."""
    other = [("aten::mm", 0, 10), ("train", 10, 20), ("serve.upload.x", 20, 30)]
    units = {"steps": 3, "requests": 3, "calls": 3}
    assert _read(name, _run(other, [("k", 0, 5)], units)) is None
    assert _read(name, SimpleNamespace(trace=None, traced=units)) is None
    every = [(n, 0, 10) for n in ("train.forward", "train.backward", "train.optimizer",
                                  "serve.upload", "serve.forward", "serve.readback",
                                  "labels.prepare", "labels.unpack", "labels.probs")]
    assert _read(name, _run(every, [], {"steps": 0, "requests": 0, "calls": 0})) is None
    assert _read(name, _run(every, [], units)) > 0


def test_forward_needs_both_of_its_spans():
    run = _run([("serve.upload", 0, 1000)], traced={"requests": 1})
    assert _read("forward_ms.serve", run) is None


@pytest.mark.parametrize("a,b,want", [
    ([], [(0, 5)], 0.0),
    ([(0, 10)], [(0, 10)], 10.0),  # identical
    ([(0, 10)], [(2, 4), (6, 7)], 3.0),  # b inside a
    ([(2, 4), (6, 7)], [(0, 10)], 3.0),  # a inside b
    ([(0, 5)], [(5, 9)], 0.0),  # touching
    ([(0, 5), (8, 12)], [(3, 9), (11, 20)], 4.0),  # staggered
    ([(0, 1), (2, 3), (4, 5)], [(0.5, 4.5)], 2.0),
])
def test_overlap(a, b, want):
    assert spans.overlap_us(a, b) == pytest.approx(want)
    assert spans.overlap_us(b, a) == pytest.approx(want)


def test_chunk_idle_per_call():
    host = [("labels.prepare", 0, 100), ("labels.unpack", 90, 200),  # overlapping spans
            ("labels.steps", 200, 900), ("labels.prepare", 1000, 1050),
            ("labels.unpack", 1900, 2000),
            ("labels.probs", 1950, 2300)]  # overlaps unpack; the stretch's last 300 us
    device = [("k", 50, 120), ("k", 60, 70), ("k", 150, 160), ("k", 190, 400),
              ("k", 1050, 1900)]  # touches prepare's end and unpack's start
    run = _run(host, device, {"calls": 2})
    # union of the spans 200 + 50 + 400 us; the device covers 70 + 10 + 10 of it
    assert _read("chunk_idle_ms.labels", run) == pytest.approx((650 - 90) / 1e3 / 2)


def test_chunk_idle_needs_each_of_its_spans():
    """A program that marks the chunks but not the probabilities gives None,
    never a part of the idle time."""
    host = [("labels.prepare", 0, 100), ("labels.unpack", 200, 300)]
    assert _read("chunk_idle_ms.labels", _run(host, [], {"calls": 1})) is None


def test_upload_bytes_per_request(monkeypatch):
    from gn_ode_sir_tpu_torch.cli import infer

    monkeypatch.setattr(infer._upload, "upload_bytes", 7 * 3_234_880)
    monkeypatch.setattr(infer._upload, "calls", 7)
    run = lambda per, cap, on_card=True: SimpleNamespace(
        on_card=on_card, traffic={"scenarios_per_request": per, "dispatch_batch": cap})
    assert _read("upload_bytes.serve", run(8, 8)) == 3_234_880
    assert _read("upload_bytes.serve", run(8, 3)) == 3 * 3_234_880
    assert _read("upload_bytes.serve", run(8, 8, on_card=False)) is None
    monkeypatch.setattr(infer._upload, "calls", 0)
    assert _read("upload_bytes.serve", run(8, 8)) is None
    monkeypatch.delattr(infer, "_upload")  # a program without the counter
    assert _read("upload_bytes.serve", run(8, 8)) is None


def _cpu_profiled(fn):
    """``fn()`` under a CPU profile, reduced as the benchmark reduces a
    card's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        out = fn()
        wall_s = time.perf_counter() - t0
    return out, profiling.reduce_events(prof.events(), wall_s)


@pytest.mark.parametrize("cell", list(READERS))
def test_readers_on_the_program(cell):
    """The program's span names are the readers': each reader finds its
    spans in a CPU profile of the cell's path at a small size."""
    wl, cfg = small.cell(cell)
    driver = harness.load_module("drivers", wl["driver"])
    st = driver.setup(cfg, wl["traffic"], small.SEED, "cpu")
    traced, trace = _cpu_profiled(lambda: driver.traced(st))
    run = SimpleNamespace(trace=trace, traced=traced)
    for name in READERS[cell]:
        value = _read(name, run)
        assert value is not None and value > 0, name
    if "chunk_idle_ms.labels" in READERS[cell]:  # no device: the spans are idle throughout
        host = profiling.merge([s for n in ("labels.prepare", "labels.unpack", "labels.probs")
                                for s in spans.spans(run, n)])
        assert _read("chunk_idle_ms.labels", run) == pytest.approx(
            profiling.union(host) / 1e3 / traced["calls"])
