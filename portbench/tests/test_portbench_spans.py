"""The readers of the program's spans and counters (``portbench.spans``):
on tiny traced runs on the CPU, on a recorded window at a hand-counted
size, and on a program with no recorder, where they read nothing."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.utils import timing
from portbench import core
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 91
NEW = ("host_ms_per_call", "mask_upload_ms_per_call",
       "materialized_gib_per_call", "setup_engine_s")


def _reader(name):
    return core.metric_reader(core.HERE, name)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tinyclique-post", "tinynet-map"])
def test_a_traced_run_reports_the_program_readings(tree, cell):
    bench, base, root = tree
    line = core.run_cell(bench, cell, SEED, 0.3, True, CPU,
                         core.process_seconds(), base, root)
    m = {k: v["value"] for k, v in line["metrics"].items()}
    suffix = ".map" if cell.endswith("map") else ""
    host = m["host_ms_per_call" + suffix]
    assert host > 0
    assert m["materialized_gib_per_call" + suffix] >= 0
    assert 0 < m["setup_engine_s"] < 60
    if not suffix:
        assert 0 < m["mask_upload_ms_per_call"] <= host
    assert line["correct"] is True


def test_the_window_is_the_newest_calls_at_their_hand_count(monkeypatch):
    """Three calls in the window of a routed 2^13-state clique: the mean
    bytes of the expanded ``w2`` (13 contractions at R2 = 2^9, Z at 2^10;
    B = 8 float32 rows) and host times that nest."""
    monkeypatch.setattr(jt.config.DEFAULT, "big_clique_min_states", 1 << 10)
    rng = np.random.default_rng(0)
    names = [f"v{i}" for i in range(13)]
    tree = jt.create_junction_tree([names[:]] + [[v] for v in names],
                                   {v: 2 for v in names})
    values = [rng.random((2,) * 13) + 0.1] + [rng.random(2) + 0.1
                                                for _ in names]
    eng = tree.engine(device="cpu", dtype=torch.float32).set_potentials(values)
    masks = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, 8, names[:6], seed=1))
    other = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, 8, names[:2], seed=1))
    with profile(activities=[ProfilerActivity.CPU]):
        eng.posterior_batch(other)          # before the window
        for _ in range(3):
            eng.posterior_batch(masks)
    run = core.Run(setup_s=1.0, calls=3)
    want = 8 * 4 * (13 * 2**9 + 2**10) / 2**30
    assert _reader("materialized_gib_per_call").read(run) == want
    host = _reader("host_ms_per_call").read(run)
    assert 0 < _reader("mask_upload_ms_per_call").read(run) < host
    assert _reader("host_ms_per_call").read(
        core.Run(setup_s=1.0, calls=10**6)) is None   # not recorded


def test_no_recorder_reads_nothing(monkeypatch):
    """A program whose ``TIMERS`` has no recorded calls (the parent of
    the recorder) gives None for every new reading."""
    monkeypatch.setattr(timing, "TIMERS", types.SimpleNamespace(
        totals={}, counts={}))
    run = core.Run(setup_s=1.0, calls=2, timers={"engine.evaluate": 0.5})
    for name in NEW + ("host_ms_per_call.map",
                       "materialized_gib_per_call.map"):
        assert _reader(name).read(run) is None, name
