"""The Ising lattice configuration (``configs/ising-grid20x20-f10.json``):
its generator against the program's, the lattice reference against the
shared junction-tree reference, the planned-contraction readers and their
roofline on hand-worked numbers, and a tiny cell of the model on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from junctiontree_tpu_torch.models import ising_grid_model
from junctiontree_tpu_torch.utils.timing import CallRecord, Span
from portbench import core, einsum_roofline, spans
from portbench import trace as tr
from portbench.lattice_reference import reference
from portbench.models import ising_grid
from portbench.reference import Reference
from portbench.tests import tiny

CPU = torch.device("cpu")
BENCH = core.load_benchmark()
CELL = "ising20x20-post-ev40"
SEED = 2**31 + 4321


def _reader(name):
    return core.metric_reader(core.HERE, name)


def _small_cfg(rows=5, cols=4, seed=3):
    cfg = dict(core.cell(BENCH, CELL)[1])
    cfg.update(rows=rows, cols=cols, model_seed=seed)
    return cfg


def test_the_configuration_is_the_published_deployment():
    entry, cfg, mix = core.cell(BENCH, CELL)
    assert (cfg["rows"], cfg["cols"], cfg["coupling_scale"],
            cfg["field_scale"]) == (20, 20, 10.0, 1.0)
    assert cfg["reduced"] == [] and cfg["dtype"] == "float32"
    assert entry["chips"] == 1 and mix["warmup_calls"] >= mix["pool"]
    sites = np.random.default_rng(0).choice(400, 40, replace=False)
    assert mix["observed"] == [f"s{i // 20}_{i % 20}" for i in sites]
    f, s, v = ising_grid.build(cfg)
    pf, ps, pv = ising_grid_model(20, 20, 10.0, 1.0, 0)
    assert f == pf and s == ps
    assert all(np.array_equal(a, b) for a, b in zip(v, pv))


@pytest.mark.parametrize("rows,cols", [(3, 4), (4, 3), (4, 4)])
def test_the_lattice_reference_is_the_junction_tree_reference(rows, cols):
    f, s, v = ising_grid.build(_small_cfg(rows, cols))
    masks = {k: m for k, m in list(_masks(s, 7).items())}
    want = Reference(f, s, v, CPU).posteriors(masks)
    got = reference(f, s, v, masks, CPU)
    for k in s:
        np.testing.assert_allclose(got["post"][k], want[0][k], atol=1e-12)
    assert np.array_equal(np.isneginf(got["logz"]), np.isneginf(want[1]))
    ok = np.isfinite(want[1])
    np.testing.assert_allclose(got["logz"][ok], want[1][ok], rtol=1e-12)


def _masks(sizes, B):
    rng = np.random.default_rng(B)
    out = {}
    for v in list(sizes)[::3]:
        m = np.zeros((B, 2), np.float32)
        m[np.arange(B), rng.integers(2, size=B)] = 1.0
        out[v] = m
    out[next(iter(out))][0] = 0.0
    return out


def test_the_reference_imports_nothing_of_the_program():
    import ast

    path = os.path.join(core.HERE, "lattice_reference.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    assert mods <= {"__future__", "re", "typing", "numpy", "torch",
                    "portbench.reference"}


def test_the_float32_sweep_is_the_float64_sweep_on_a_frustrated_lattice():
    """Couplings of scale 20, a third of the spins observed: a forward and a
    backward vector, each divided by its own maximum, multiply to below
    float32's least normal value at some sites, and the float32 sweep forms
    that product in float64."""
    f, s, v = ising_grid_model(6, 6, 20.0, seed=1)
    rng = np.random.default_rng(1)
    masks = {}
    for k in list(s)[::3]:
        masks[k] = np.zeros((8, 2), np.float32)
        masks[k][np.arange(8), rng.integers(2, size=8)] = 1.0
    want = reference(f, s, v, masks, CPU)
    got = reference(f, s, v, masks, CPU, torch.float32)
    for k in s:
        np.testing.assert_allclose(got["post"][k], want["post"][k], atol=1e-6)
    np.testing.assert_allclose(got["logz"], want["logz"], rtol=1e-6)


def test_the_tf32_control_rounds_every_multiply():
    """TF32's 10-bit mantissa: the control lies further from the float64
    sweep than the float32 sweep does, and it takes float32 alone."""
    f, s, v = ising_grid.build(_small_cfg(5, 5))
    masks = _masks(s, 6)
    want = reference(f, s, v, masks, CPU)

    def err(ans):
        return max(np.abs(ans["post"][k] - want["post"][k]).max() for k in s)

    f32 = reference(f, s, v, masks, CPU, torch.float32)
    tf32 = reference(f, s, v, masks, CPU, torch.float32, tf32=True)
    assert err(f32) < 1e-5 < err(tf32) < 1e-1
    with pytest.raises(ValueError):
        reference(f, s, v, masks, CPU, torch.float64, tf32=True)


# -- the readers ---------------------------------------------------------------

def test_the_einsum_roofline_of_one_contraction_by_hand():
    """An up message of the cell: the 2^21-state potential (8 MiB) times a
    [128, 2^20] child message, onto a [128, 2^20] separator: 2 x 128 x 2^21
    operations (5.37e8: 8.0 us at 66.9 TFLOP/s) against 8 MiB + 2 x 512 MiB
    (0.3231 ms at 3.35 TB/s): bound by the bytes."""
    nbytes = (1 << 23) + 2 * (128 << 22)
    ops, got_bytes, t, by = einsum_roofline.contraction(128, 1 << 21, nbytes)
    assert ops == 536870912 and got_bytes == 1082130432 and by == "bytes"
    assert t == pytest.approx(1082130432 / 3.35e12)
    ops, _, t, by = einsum_roofline.contraction(4096, 1 << 21, 1 << 20)
    assert by == "operations"
    assert t == pytest.approx(2 * 4096 * 2 ** 21 / (132 * 128 * 2 * 1.98e9))
    assert einsum_roofline.span_bound_s({"B": 1, "states": 2}) is None


def _trace(span_s):
    return tr.Trace(calls=2, window_s=1.0, busy_s=0.9, kernels=[],
                    span_device_s=dict(span_s))


def _call(i, attrs_list):
    return CallRecord(i, [Span("serve.posterior_batch", 0, 10, None, i, {})]
                      + [Span("route.einsum", 1, 2, 0, i, a)
                         for a in attrs_list])


def test_the_planned_contract_readers_read_their_spans(monkeypatch):
    a = {"B": 128, "states": 1 << 21, "bytes": 1 << 30}
    b = {"B": 1, "states": 8, "bytes": 96}
    records = [_call(i, [a, b]) for i in range(3)]
    monkeypatch.setattr(spans, "recorder", lambda: type(
        "R", (), {"calls": staticmethod(lambda: records)}))
    run = core.Run(setup_s=0.0, calls=2, trace=_trace(
        {"route.einsum": 0.004, "serve.posterior_batch": 0.1}))
    assert _reader("planned_contract_ms_per_call").read(run) \
        == pytest.approx(2.0)
    bound = 2 * (einsum_roofline.span_bound_s(a)
                 + einsum_roofline.span_bound_s(b))
    assert _reader("planned_contract_roofline").read(run) \
        == pytest.approx(100 * bound / 0.004)
    # the parent's spans carry no shape; no span, no trace: nothing to read
    records[:] = [_call(i, [{}]) for i in range(3)]
    assert _reader("planned_contract_roofline").read(run) is None
    run.trace = _trace({"serve.posterior_batch": 0.1})
    for name in ("planned_contract_ms_per_call", "planned_contract_roofline"):
        assert _reader(name).read(run) is None
        assert _reader(name).read(core.Run(setup_s=0.0, calls=2)) is None


# -- a tiny cell of the model on the CPU ---------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny benchmark copy with a 6 x 6 lattice cell added."""
    bench, base, root = tiny.make(tmp_path_factory.mktemp("bench"))
    cfg = dict(_small_cfg(6, 6, 0), name="tinylattice")
    with open(os.path.join(base, "configs", "tinylattice.json"), "w") as f:
        json.dump(cfg, f)
    mix = dict(core.cell(BENCH, CELL)[2], batch=16, pool=2, warmup_calls=2,
               trace_calls=2, check_rows=5,
               observed=[f"s{r}_{c}" for r in range(6) for c in range(6)][::4])
    with open(os.path.join(base, "traffic", "tiny_post_lattice.json"),
              "w") as f:
        json.dump(mix, f)
    bench["configs"].append({"name": "tinylattice", "source": "test",
                             "file": "portbench/configs/tinylattice.json",
                             "reduced": ["rows", "cols"], "why": "test"})
    bench["workloads"].append({"name": "tinylattice-post",
                               "config": "tinylattice",
                               "traffic": "tiny_post_lattice", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tinylattice-post")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench, base, root


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_of_the_model_is_correct_on_the_cpu(tree, trace):
    from junctiontree_tpu_torch.utils.timing import TIMERS

    bench, base, root = tree
    line = core.run_cell(bench, "tinylattice-post", SEED, 0.3, trace, CPU,
                         core.process_seconds(), base, root)
    assert line["correct"] is True and line["failed"] == 0
    if not trace:
        assert {"queries_per_s", "step_p95_ms", "setup_s"} <= set(
            line["metrics"])
        return
    assert "host_ms_per_call" in line["metrics"]
    einsums = TIMERS.calls()[-1].named("route.einsum")
    assert einsums and all(set(s.attrs) == {"B", "states", "bytes"}
                           for s in einsums)
