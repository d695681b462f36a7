"""The Li-Stephens configuration (``configs/lshmm-k500-m256.json``): its
generator against the program's, the harness's reference against the
published recursion (``lshmm_reference.py`` beside this file), the chain
program's readers on synthetic records, a tiny cell of the model on the
CPU, and on the card the model at its size."""

import numpy as np
import pytest
import torch

from junctiontree_tpu_torch.models.hmm import li_stephens_model
from junctiontree_tpu_torch.utils.timing import CallRecord, Span
from portbench import chain_roofline, core, evidence, spans
from portbench import trace as tr
from portbench.models import lshmm
from portbench.reference import Reference
from portbench.tests import tiny
from portbench.tests.lshmm_reference import forward_backward

CPU = torch.device("cpu")
BENCH = core.load_benchmark()
CELL = "lshmm500-post-b16384"
SEED = 2**31 + 1234


def _reader(name):
    return core.metric_reader(core.HERE, name)


def _small_cfg(K=8, M=12, seed=3):
    cfg = dict(core.cell(BENCH, CELL)[1])
    cfg.update(templates=K, sites=M, model_seed=seed)
    return cfg


@pytest.mark.parametrize("K,M,seed", [(8, 12, 3), (20, 7, 0), (3, 30, 9)])
def test_the_generator_is_the_programs(K, M, seed):
    f, s, v = lshmm.build(_small_cfg(K, M, seed))
    pf, ps, pv = li_stephens_model(K, M, seed=seed)
    assert f == pf and s == ps and len(v) == len(pv)
    for a, b in zip(v, pv):
        np.testing.assert_array_equal(a, b)


def test_the_configuration_is_the_published_deployment():
    entry, cfg, mix = core.cell(BENCH, CELL)
    assert (cfg["templates"], cfg["Ne"], cfg["sites"]) == (500, 20000, 256)
    assert cfg["reduced"] == ["sites"] and entry["chips"] == 1
    assert mix["observed"] == [f"y{m}" for m in range(0, 256, 10)]
    assert (mix["batch"], mix["pool"], mix["impossible_rows"]) == (
        16384, 4, [0])


# -- the reference against the Li-Stephens recursion --------------------------

def _against_recursion(K, M, rows, device, seed):
    f, s, v = lshmm.build(_small_cfg(K, M, seed))
    mix = {"observed": [f"y{m}" for m in range(0, M, 10 if M > 30 else 3)]}
    masks = evidence.mask_batch([seed, 0], rows, mix["observed"], s, [0])
    post, logz = Reference(f, s, v, device).posteriors(masks)
    prior = torch.as_tensor(v[0])
    stay = torch.as_tensor([t[0, 0] - t[0, 1] for t, fa in zip(v, f)
                            if len(fa) == 2 and fa[1][0] == "x"])
    emit = torch.as_tensor(np.stack([t for t, fa in zip(v, f)
                                     if len(fa) == 2 and fa[1][0] == "y"]))
    obs = {int(k[1:]): torch.as_tensor(m, dtype=torch.float64)
           for k, m in masks.items()}
    hidden, allele, want_z = forward_backward(prior, stay, emit, obs, rows)
    assert np.isneginf(logz[0]) and np.isneginf(want_z[0].item())
    np.testing.assert_allclose(logz[1:], want_z[1:].numpy(), rtol=1e-10)
    for m in range(M):
        np.testing.assert_allclose(post[f"x{m}"], hidden[m].numpy(),
                                   atol=1e-10)
        np.testing.assert_allclose(post[f"y{m}"], allele[m].numpy(),
                                   atol=1e-10)


def test_the_reference_is_the_li_stephens_recursion():
    _against_recursion(10, 14, 6, CPU, 5)


@pytest.mark.cuda
def test_the_reference_is_the_li_stephens_recursion_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the reference at K = 500, M = 256")
    _against_recursion(500, 256, 64, torch.device("cuda", 0), 0)


# -- the readers ----------------------------------------------------------------

def test_the_roofline_of_one_product_by_hand():
    assert chain_roofline.FP32_FLOPS == pytest.approx(66.90816e12)
    ops, nbytes, sec, by = chain_roofline.product(16384, 500, 500)
    assert (ops, nbytes, by) == (8_192_000_000, 66_536_000, "operations")
    assert sec == pytest.approx(8.192e9 / 66.90816e12)
    ops, nbytes, sec, by = chain_roofline.product(16384, 500, 2)
    assert (ops, nbytes, by) == (32_768_000, 32_903_072, "bytes")
    assert sec == pytest.approx(32_903_072 / 3.35e12)
    attrs = {"products": [[255, 16384, 500, 500], [26, 16384, 2, 500]]}
    assert chain_roofline.span_bound_s(attrs) == pytest.approx(
        255 * 8.192e9 / 66.90816e12 + 26 * 4 * (32768 + 1000 + 8192000)
        / 3.35e12)
    assert chain_roofline.span_bound_s({}) == 0


def _trace(span_s, kernels=()):
    return tr.Trace(calls=2, window_s=1.0, busy_s=0.9, kernels=list(kernels),
                    span_device_s=dict(span_s))


def test_the_pass_and_leaf_readers_read_their_spans():
    t = _trace({"chain.forward": 0.03, "chain.backward": 0.05,
                "chain.leaves": 0.004, "serve.posterior_batch": 0.1})
    run = core.Run(setup_s=0.0, calls=2, trace=t)
    assert _reader("chain_pass_ms_per_call").read(run) == pytest.approx(40.0)
    assert _reader("hmm_leaves_ms_per_call").read(run) == pytest.approx(2.0)
    # a program without the spans (the parent's, another cell's)
    run = core.Run(setup_s=0.0, calls=2, trace=_trace(
        {"serve.posterior_batch": 0.1}))
    for name in ("chain_pass_ms_per_call", "hmm_leaves_ms_per_call"):
        assert _reader(name).read(run) is None
        assert _reader(name).read(core.Run(setup_s=0.0, calls=2)) is None


def _call(i, span_list):
    return CallRecord(i, [Span("serve.posterior_batch", 0, 10, None, i, {})]
                      + [Span(n, 1, 2, 0, i, a) for n, a in span_list])


def test_the_gemm_roofline_reads_the_spans_products(monkeypatch):
    fwd = {"products": [[3, 100, 50, 50]]}
    leaves = {"products": [[2, 100, 50, 2]]}
    records = [_call(i, [("chain.leaves", leaves), ("chain.forward", fwd),
                         ("chain.backward", fwd), ("map.collect", fwd)])
               for i in range(3)]
    monkeypatch.setattr(spans, "recorder", lambda: type(
        "R", (), {"calls": staticmethod(lambda: records)}))
    kernels = [("ampere_sgemm_64x64_nn", 2e-6), ("void gemmSN_NN_kernel", 1e-6),
               ("elementwise_kernel", 5e-6)]
    run = core.Run(setup_s=0.0, calls=2, trace=_trace({}, kernels))
    bound = 2 * (2 * chain_roofline.product(100, 50, 50)[2] * 3
                 + 2 * chain_roofline.product(100, 50, 2)[2])
    got = _reader("chain_gemm_roofline").read(run)
    assert got == pytest.approx(100 * bound / 3e-6)
    # no gemm kernel, or no chain span: nothing to read
    run.trace = _trace({}, kernels[2:])
    assert _reader("chain_gemm_roofline").read(run) is None
    records[:] = [_call(i, [("map.collect", fwd)]) for i in range(3)]
    run.trace = _trace({}, kernels)
    assert _reader("chain_gemm_roofline").read(run) is None


# -- a tiny cell of the model on the CPU ---------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny benchmark copy with a tiny Li-Stephens cell added."""
    import json
    import os

    bench, base, root = tiny.make(tmp_path_factory.mktemp("bench"))
    cfg = dict(_small_cfg(6, 15, 0), name="tinyhmm")
    with open(os.path.join(base, "configs", "tinyhmm.json"), "w") as f:
        json.dump(cfg, f)
    mix = dict(tiny._MIX, surface="posterior_batch", control="reference_tf32",
               observed=["y0", "y5", "y10"], impossible_rows=[0],
               limits={"post_err": 1e-5, "logz_err": 1e-4, "bad_rows": 0})
    with open(os.path.join(base, "traffic", "tiny_post_hmm.json"), "w") as f:
        json.dump(mix, f)
    bench["configs"].append({"name": "tinyhmm", "source": "test",
                             "file": "portbench/configs/tinyhmm.json",
                             "reduced": ["sites"], "why": "test"})
    bench["workloads"].append({"name": "tinyhmm-post", "config": "tinyhmm",
                               "traffic": "tiny_post_hmm", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tinyhmm-post")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench, base, root


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_of_the_model_is_correct_on_the_cpu(tree, trace):
    from junctiontree_tpu_torch.utils.timing import TIMERS

    bench, base, root = tree
    line = core.run_cell(bench, "tinyhmm-post", SEED, 0.3, trace, CPU,
                         core.process_seconds(), base, root)
    assert line["correct"] is True and line["failed"] == 0
    if not trace:
        assert {"queries_per_s", "step_p95_ms", "setup_s"} <= set(
            line["metrics"])
        return
    assert "host_ms_per_call" in line["metrics"]
    names = [s.name for s in TIMERS.calls()[-1].spans]
    assert names.count("chain.leaves") == 2 and "chain.forward" in names


# -- on the card -------------------------------------------------------------------

@pytest.mark.cuda
def test_only_the_chain_launches_gemm_kernels_in_the_cells_program():
    """At the cell's widths (B cut to 2,048 rows), every kernel whose name
    holds "gemm" was launched from a chain span, and the roofline share
    lies in (0, 100]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's kernels")
    from torch.profiler import ProfilerActivity, profile, record_function

    import junctiontree_tpu_torch as jt

    _, cfg, mix = core.cell(BENCH, CELL)
    gen = core.load_module(core.HERE, "models", cfg["generator"])
    surface = core.load_module(core.HERE, "surfaces", mix["surface"])
    dev = torch.device("cuda", 0)
    factors, sizes, values = gen.build(cfg)
    pool = evidence.pool(SEED, dict(mix, batch=2048, pool=2), sizes)
    eng = surface.engine(jt, factors, sizes, values, dev, cfg)
    surface.call(eng, pool[0])
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in pool:
            with record_function(tr.MARK):
                surface.call(eng, b)
                torch.cuda.synchronize(dev)
    assert eng._route("auto") == "hmm" and ("hmm",) in eng._programs
    events = prof.profiler.kineto_results.events()
    t = tr.read_events(events)
    gemm = [e for e in events if tr._is_device(e)
            and "gemm" in e.name().lower()]
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if tr._is_launch(e))
    chain = [(e.name(), e.start_ns(), e.end_ns()) for e in events
             if tr._is_annotation(e) and not tr._is_device(e)
             and e.name() in chain_roofline.SPANS]
    inside = tr._span_device_s(
        [("chain", s, e) for _, s, e in chain], launches,
        [(e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
         for e in gemm])
    total = sum(e.end_ns() - e.start_ns() for e in gemm) / 1e9
    print(sorted({e.name()[:100] for e in gemm}))
    assert total > 0 and inside["chain"] == pytest.approx(total, rel=1e-9)
    share = _reader("chain_gemm_roofline").read(core.Run(
        setup_s=0.0, calls=len(pool), trace=t))
    assert 0 < share <= 100, share
