"""BENCHMARK.json against the benchmark's contract, and every piece it names
found by its name, a new one too, with no file edited."""

import json
import os
import re

import pytest

from portbench import core
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [x["name"]
             for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    # the MAP cell's step is host-bound since its collect became one kernel:
    # its bounds are three times the widest quartile spread of its sets
    assert e2e["queries_per_s.map"]["bound"] == 0.17
    assert e2e["step_p95_ms.map"]["bound"] == 0.14
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    cells = [w["name"] for w in BENCH["workloads"]]
    for w in cells:
        e2e = [m["name"] for m in core.metrics_of(BENCH, w, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.metrics_of(BENCH, w, True)


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            e2e = [e["name"] for e in core.metrics_of(BENCH, w, False)]
            assert m["moves"] in e2e, (m["name"], w)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(workload):
    entry, cfg, mix = core.cell(BENCH, workload)
    core.load_module(core.HERE, "models", cfg["generator"])
    surface = core.load_module(core.HERE, "surfaces", mix["surface"])
    for fn in ("batches", "engine", "call", "take", "reference", "compare",
               "judge", "control"):
        assert callable(getattr(surface, fn))
    for m in (core.metrics_of(BENCH, workload, False)
              + core.metrics_of(BENCH, workload, True)):
        assert callable(core.metric_reader(core.HERE, m["name"]).read)
    assert set(mix["limits"]) and mix["batch"] > max(mix["impossible_rows"])
    names = {c["name"]: c for c in BENCH["configs"]}
    assert cfg["name"] == entry["config"]
    assert sorted(cfg["reduced"]) == sorted(names[entry["config"]]["reduced"])


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        core.cell(BENCH, "no-such-cell")
    with pytest.raises(KeyError):
        core.load_module(core.HERE, "metrics", "no_such_metric")
    with pytest.raises(KeyError):
        core.metric_reader(core.HERE, "no_such_metric.map")


def test_a_qualified_metric_is_read_by_its_base_reader(tmp_path):
    bench, base, root = tiny.make(tmp_path)
    run = core.Run(setup_s=0.0, rows=30, window_s=2.0)
    assert core.metric_reader(base, "queries_per_s.map").read(run) == 15.0
    # a qualified metric with a file of its own is read by that file
    with open(os.path.join(base, "metrics", "queries_per_s.busy.py"),
              "w") as f:
        f.write("def read(run):\n    return -1.0\n")
    assert core.metric_reader(base, "queries_per_s.busy").read(run) == -1.0


def _files(base):
    out = set()
    for dirpath, dirs, files in os.walk(base):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "tests")]
        out |= {os.path.relpath(os.path.join(dirpath, f), base) for f in files}
    return out


def test_a_new_config_mix_and_metric_are_found_without_edits(tmp_path):
    # the tiny cells come as new configuration and mix files and new
    # BENCHMARK.json entries; a new metric comes the same way
    bench, base, root = tiny.make(tmp_path)
    with open(os.path.join(base, "metrics", "calls_seen.py"), "w") as f:
        f.write("def read(run):\n    return float(run.calls)\n")
    bench["per_layer"].append({
        "name": "calls_seen", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "Serving program",
        "moves": "queries_per_s", "workloads": ["tinynet-map"]})
    entry, cfg, mix = core.cell(bench, "tinynet-map", base, root)
    assert cfg["nodes"] == 10 and mix["surface"] == "map_assignment_batch"
    traced = [m["name"] for m in core.metrics_of(bench, "tinynet-map", True)]
    assert "calls_seen" in traced
    assert core.load_module(base, "metrics", "calls_seen").read(
        core.Run(setup_s=0.0, calls=3)) == 3.0
    # every file the benchmark had is there, byte for byte
    old, new = _files(core.HERE), _files(base)
    assert old < new
    for rel in old:
        with open(os.path.join(core.HERE, rel), "rb") as a, open(
                os.path.join(base, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert sorted(new - old) == sorted(
        [os.path.join("configs", c + ".json") for c in tiny.TINY_CONFIGS]
        + [os.path.join("traffic", m + ".json") for m in tiny.TINY_MIXES]
        + [os.path.join("metrics", "calls_seen.py")])
