"""The registry: every cell, configuration and metric in ``BENCHMARK.json``
has its files, and the file keeps to the benchmark's contract."""

import json
import re

import pytest

from perfbench import faults, harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DRIVER_API = ("setup", "window", "traced", "check", "shapes", "attempted", "plant", "control_run")


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_workload_names_existing_files(cell):
    entry = harness.cell_entry(BENCH, cell)
    wl = harness.load_workload(cell)
    assert wl["config"] == entry["config"]
    assert (harness.HERE / "configs" / f"{wl['config']}.json").is_file()
    cfg = harness.load_config(wl["config"])
    assert (harness.HERE / "reference" / f"{cfg['reference']}.py").is_file()
    driver = harness.load_module("drivers", wl["driver"])
    assert all(callable(getattr(driver, f, None)) for f in DRIVER_API)
    assert set(faults.applicable(wl["driver"], cfg, wl["traffic"])) <= set(driver.FAULTS)
    assert faults.applicable(wl["driver"], cfg, wl["traffic"])
    for name in getattr(driver, "SPAN_METRICS", ()):  # the cell reports its driver's spans
        assert cell in next(m for m in BENCH["per_layer"] if m["name"] == name)["workloads"]
    metrics = harness.cell_metrics(BENCH, cell, False) + harness.cell_metrics(BENCH, cell, True)
    names = {m["name"] for m in metrics}
    assert "setup_s" in names and len(harness.cell_metrics(BENCH, cell, False)) >= 2
    assert harness.cell_metrics(BENCH, cell, True), "every cell reports a per-layer metric"
    for m in metrics:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["workloads"], "a per-layer metric names its cells"
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(BENCH, cell, False)}
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/") and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_metric_file_is_listed():
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    assert listed == files
