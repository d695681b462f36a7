"""Runs of tiny cells on the CPU: the last line's format, and a run whose
timed path is broken underneath coming out not correct."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from junctiontree_tpu_torch.executor import Engine
from portbench import core
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def _run(tree, cell, trace=False, seconds=0.3):
    bench, base, root = tree
    return core.run_cell(bench, cell, SEED, seconds, trace, CPU,
                         core.process_seconds(), base, root)


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_format(tree, cell, trace):
    line = _run(tree, cell, trace)
    assert list(line) == (["correct", "attempted", "failed", "metrics",
                           "device"] + (["breakdown"] if trace else [])
                          + ["build_s", "checks"])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and line["attempted"] % 16 == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and dev["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "compile_s" in line["metrics"]
    else:
        assert {"queries_per_s", "setup_s"} <= set(line["metrics"])
        assert "step_p95_ms" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(line))


def test_setup_stages_end_in_order_and_sum_to_setup_s(tree, capsys):
    bench, base, root = tree
    t0, start = core.process_seconds(), time.perf_counter()
    stages = []
    line = core.run_cell(bench, "tinynet-map", SEED, 0.2, False, CPU, t0,
                         base, root, stages=stages)
    assert [n for n, _ in stages] == ["program import", "kernel library",
                                      "model", "evidence pool", "engine",
                                      "warm-up calls"]
    ends = [t for _, t in stages]
    assert ends == sorted(ends) and ends[0] >= start
    core.print_stages(stages, start, line["build_s"])
    printed = [float(ln.rsplit(": ", 1)[1][:-2])
               for ln in capsys.readouterr().err.splitlines()]
    assert len(printed) == 6 and min(printed) >= 0
    setup = line["metrics"]["setup_s"]["value"]
    assert sum(printed) == pytest.approx(setup, abs=0.05)


# -- faults planted in the program's serving entry points ---------------------

def _stale(fn):
    """The answer of the previous call, not of this one."""
    prev = {}

    def broken(self, batch, *a, **k):
        out = fn(self, batch, *a, **k)
        ans, prev["out"] = prev.get("out", out), out
        return ans
    return broken


def _half_batch(fn):
    """Only the first half of the rows served; the rest given their mean."""
    def broken(self, batch, *a, **k):
        B = len(next(iter(batch.values())))
        half = {v: m[: B // 2] for v, m in batch.items()}
        a0, b0 = fn(self, half, *a, **k)

        def fill(t):
            mean = t.double().mean(0, keepdim=True).to(t.dtype)
            return torch.cat([t, mean.expand((B - B // 2,) + t.shape[1:])])
        if isinstance(a0, list):
            return [fill(p) for p in a0], fill(b0)
        return fill(a0), fill(b0)
    return broken


def _altered(fn):
    """Every row's answer altered where it is produced: logZ (or a MAP
    assignment's first variable) moved."""
    def broken(self, batch, *a, **k):
        first, second = fn(self, batch, *a, **k)
        if isinstance(first, torch.Tensor):     # MAP: assignments, scores
            first = first.clone()
            first[:, 0] = (first[:, 0] + 1) % self.plan.sizes[0]
            return first, second
        return first, second + 1e-3
    return broken


FAULTS = {"stale": _stale, "half_batch": _half_batch, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_a_broken_timed_path_is_not_correct(tree, cell, fault, monkeypatch):
    entry = ("map_assignment_batch" if cell.endswith("map")
             else "posterior_batch")
    monkeypatch.setattr(Engine, entry, FAULTS[fault](getattr(Engine, entry)))
    line = _run(tree, cell)
    assert line["correct"] is False and line["failed"] >= 1
    assert any(c["value"] > c["limit"] if isinstance(c["value"], float)
               else True for c in line["checks"].values())


def test_no_cuda_exits_nonzero_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cmd = [sys.executable, os.path.join(core.HERE, "run.py"), "--workload",
           core.load_benchmark()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=core.ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_forbidden_modules_are_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "junctiontree_tpu.fake", object())
    assert core.forbidden_modules() == ["junctiontree_tpu.fake"]


def test_the_sample_holds_the_impossible_rows():
    mix = {"batch": 50, "impossible_rows": [1], "check_rows": 5, "pool": 4}
    rows = core.sample_rows(2**32 + 1, mix)
    assert len(rows) == 4 and all(1 in r and len(r) >= 5 for r in rows)
    assert rows == core.sample_rows(2**32 + 1, mix)
    assert np.unique([tuple(r) for r in rows], axis=0).shape[0] > 1
