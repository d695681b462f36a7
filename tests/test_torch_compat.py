"""The port's compatibility surface case for case with ``tests/test_compat.py``,
plus the ``Config``, ``apply_evidence`` and timer cases of
``tests/test_aux.py``, ``find_subtree`` of ``tests/test_construction.py``,
and the ``Engine`` names of the same slice (``set_potentials(dtype=)``,
``query_batch_vmap``, ``utils.timing.device_trace``) and the package's
matmul precision.

Every case runs the port on the CPU and holds it to the JAX package's own
function on the same inputs (float64 on both sides: rtol 1e-9; where the JAX
function computes in float32, as ``CliqueGraph.evaluate`` does, rtol 1e-6)
and to the brute-force oracle where ``tests/test_compat.py`` does."""

import json
import os

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu import api as jax_api
from junctiontree_tpu import computation as jax_computation
from junctiontree_tpu import construction as jax_construction
from junctiontree_tpu import sum_product as jax_sum_product
from junctiontree_tpu.config import Config as JaxConfig
from junctiontree_tpu_torch import computation, construction, sum_product
from junctiontree_tpu_torch.api import einsum as kv_einsum
from junctiontree_tpu_torch.config import Config
from junctiontree_tpu_torch.executor import evaluate_cliques, propagate_cliques
from junctiontree_tpu_torch.ops import semirings
from junctiontree_tpu_torch.utils.timing import PhaseTimers, device_trace

from .util import brute_force_marginals, grid_mrf, random_values

CPU = torch.device("cpu")


def _pots(plan, values, dtype=torch.float64):
    return evaluate_cliques(
        plan, [torch.as_tensor(np.asarray(v), dtype=dtype) for v in values])


def test_find_triangulation_label_space():
    factors, sizes = grid_mrf(2, 3)
    fill, cliques, f2c = construction.find_triangulation(factors, sizes)
    assert (fill, cliques, f2c) == jax_construction.find_triangulation(factors, sizes)
    assert len(f2c) == len(factors)
    for f, c in zip(factors, f2c):
        assert set(f) <= set(cliques[c])
    for a, b in fill:
        assert a in sizes and b in sizes


def test_construct_junction_tree_label_space():
    factors, sizes = grid_mrf(2, 2)
    _, cliques, _ = construction.find_triangulation(factors, sizes)
    tree, seps = construction.construct_junction_tree(cliques, sizes)
    assert (tree, seps) == jax_construction.construct_junction_tree(cliques, sizes)
    assert isinstance(tree, list) and isinstance(tree[0], int)

    def walk(node):
        for sep, sub in node[1:]:
            assert sep >= len(cliques)
            assert set(seps[sep - len(cliques)]) <= set(cliques[node[0]])
            walk(sub)

    walk(tree)


def test_compute_beliefs_facade():
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=31)
    plan = jt.compile_plan(factors, sizes)
    pots = [p.numpy() for p in _pots(plan, values)]
    cb, sb = computation.compute_beliefs(plan, pots, device="cpu")
    jcb, jsb = jax_computation.compute_beliefs(jt_jax.compile_plan(factors, sizes), pots)
    assert len(cb) == plan.tri.num_cliques
    assert len(sb) == len(plan.tree.separators)
    for a, b in zip(cb + sb, jcb + jsb):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    for c, b in enumerate(cb):
        labels = plan.table.labels_of(plan.clique_vars[c])
        (expect,) = brute_force_marginals(factors, sizes, values, [labels])
        np.testing.assert_allclose(b, expect, rtol=1e-9)


def test_sum_product_interleaved_einsum():
    rng = np.random.default_rng(0)
    a = rng.random((2, 3))
    b = rng.random((3, 4))
    sp = sum_product.SumProduct(device="cpu")
    got = sp.einsum(a, ["x", "y"], b, ["y", "z"], ["x", "z"])
    np.testing.assert_allclose(got, a @ b, rtol=1e-9)
    # arbitrary hashable labels, including tuples
    got2 = sp.einsum(a, [(0,), 1], b, [1, "z"], [(0,)])
    np.testing.assert_allclose(got2, (a @ b).sum(axis=1), rtol=1e-9)
    jsp = jax_sum_product.SumProduct()
    np.testing.assert_allclose(
        got2, jsp.einsum(a, [(0,), 1], b, [1, "z"], [(0,)]), rtol=1e-9)


def test_sum_product_max_semiring():
    rng = np.random.default_rng(1)
    a = np.log(rng.random((2, 3)) + 0.1)
    sp = sum_product.SumProduct("max_product", device="cpu")
    got = sp.einsum(a, ["x", "y"], ["x"])
    np.testing.assert_allclose(got, a.max(axis=1), rtol=1e-9)
    jgot = jax_sum_product.SumProduct("max_product").einsum(a, ["x", "y"], ["x"])
    np.testing.assert_allclose(got, jgot, rtol=1e-9)


def test_sum_product_bad_args():
    sp = sum_product.SumProduct(device="cpu")
    with pytest.raises(ValueError):
        sp.einsum(np.ones(2), ["x"])  # even arg count


def test_apply_evidence_reexport():
    assert computation.apply_evidence is jt.apply_evidence
    assert computation.sum_product is jt.SUM_PRODUCT


def test_api_einsum_output_only_keys():
    rng = np.random.default_rng(0)
    a = rng.random((3, 4))
    got = kv_einsum([a], [["x", "y"]], ["w", "x"], device="cpu")
    assert got.shape == (1, 3)
    np.testing.assert_allclose(got[0], a.sum(axis=1), rtol=1e-9)
    b = rng.random((4, 2))
    got2 = kv_einsum([a, b], [[0, 1], [1, ("z",)]], [0, ("z",)], device="cpu")
    np.testing.assert_allclose(got2, a @ b, rtol=1e-9)
    got3 = kv_einsum([np.array(2.5)], [[]], ["p", "q"], device="cpu")
    assert got3.shape == (1, 1)
    np.testing.assert_allclose(got3, [[2.5]])
    # the JAX function on the same calls; transposed output order too
    for args in (([a], [["x", "y"]], ["w", "x"]),
                 ([a, b], [[0, 1], [1, ("z",)]], [0, ("z",)]),
                 ([a, b], [[0, 1], [1, 2]], [2, "new", 0])):
        np.testing.assert_allclose(kv_einsum(*args, device="cpu"),
                                   jax_api.einsum(*args), rtol=1e-9)


def test_clique_graph_marginalize_roundtrip():
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=12)
    tree = jt.create_junction_tree(factors, sizes)
    beliefs, _ = propagate_cliques(tree.plan, _pots(tree.plan, values))
    out = tree.clique_tree.marginalize([b.numpy() for b in beliefs], device="cpu")
    jtree = jt_jax.create_junction_tree(factors, sizes)
    jout = jtree.clique_tree.marginalize([b.numpy() for b in beliefs])
    expect = brute_force_marginals(factors, sizes, values, factors)
    for o, j, e in zip(out, jout, expect):
        assert o.shape == e.shape
        np.testing.assert_allclose(o, e, rtol=1e-9)
        np.testing.assert_allclose(o, j, rtol=1e-9)


def test_sum_product_pluggable_einsum_backend():
    calls = []

    def my_einsum(subscripts, *arrays, **kw):
        calls.append((subscripts, kw))
        return np.einsum(subscripts, *arrays)

    sp = sum_product.SumProduct(my_einsum, optimize=True)
    a = np.random.default_rng(0).random((2, 3))
    b = np.random.default_rng(1).random((3, 4))
    got = sp.einsum(a, ["x", "y"], b, ["y", "z"], ["x", "z"])
    np.testing.assert_allclose(got, a @ b, rtol=1e-12)
    assert calls and calls[0][1] == {"optimize": True}
    # the same subscripts as the JAX facade hands its callable
    jcalls = []
    jax_sum_product.SumProduct(
        lambda s, *xs, **kw: jcalls.append(s) or np.einsum(s, *xs)
    ).einsum(a, ["x", "y"], b, ["y", "z"], ["x", "z"])
    assert calls[0][0] == jcalls[0]


def _uncovered_case():
    factors = [["a", "b"], ["b", "c"], ["c", "d"], ["a", "e"]]
    sizes = {"a": 2, "b": 3, "c": 4, "d": 5, "e": 6}
    return factors, sizes


def test_evaluate_size1_uncovered_semantics():
    """``size1_uncovered=True``: a clique variable not covered by any factor
    assigned to that clique keeps a length-1 axis; the full table is its
    broadcast, and both equal the product of the assigned factors."""
    factors, sizes = _uncovered_case()
    values = random_values(factors, sizes, seed=21)
    cg = jt.FactorGraph(factors, sizes).triangulate()
    full = cg.evaluate(values, device="cpu")
    compat = cg.evaluate(values, size1_uncovered=True, device="cpu")
    for c, clique in enumerate(cg.maxcliques):
        covered = set()
        for f_ix, mc in enumerate(cg.factor_to_maxclique):
            if mc == c:
                covered.update(factors[f_ix])
        want_shape = tuple(sizes[v] if v in covered else 1 for v in clique)
        assert compat[c].shape == want_shape, (clique, covered)
        assert full[c].shape == tuple(sizes[v] for v in clique)
        np.testing.assert_allclose(
            full[c], np.broadcast_to(compat[c], full[c].shape), rtol=1e-6)
        oracle = np.ones([1] * len(clique))
        for f_ix, mc in enumerate(cg.factor_to_maxclique):
            if mc != c:
                continue
            fv = np.asarray(values[f_ix], dtype=np.float64)
            perm = sorted(range(len(factors[f_ix])),
                          key=lambda i: clique.index(factors[f_ix][i]))
            shape = [1] * len(clique)
            for v in factors[f_ix]:
                shape[clique.index(v)] = sizes[v]
            oracle = oracle * np.transpose(fv, perm).reshape(shape)
        np.testing.assert_allclose(compat[c], oracle, rtol=1e-6)


def test_evaluate_size1_uncovered_vs_jax():
    """Both forms of ``CliqueGraph.evaluate`` against the JAX package's
    (both compute in float32), clique by clique."""
    factors, sizes = _uncovered_case()
    values = random_values(factors, sizes, seed=22)
    cg = jt.FactorGraph(factors, sizes).triangulate()
    jcg = jt_jax.FactorGraph(factors, sizes).triangulate()
    assert cg.maxcliques == jcg.maxcliques
    for flag in (False, True):
        ours = cg.evaluate(values, size1_uncovered=flag, device="cpu")
        theirs = jcg.evaluate(values, size1_uncovered=flag)
        for a, b in zip(ours, theirs):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-6)


def test_find_subtree_reference_contract():
    factors = [["a", "b"], ["b", "c"], ["c", "d"], ["x", "y"]]
    sizes = {"a": 2, "b": 2, "c": 2, "d": 2, "x": 3, "y": 3}
    _, cliques, _ = construction.find_triangulation(factors, sizes)
    tree, seps = construction.construct_junction_tree(cliques, sizes)
    for c in range(len(cliques)):
        assert construction.find_subtree(tree, c)
    assert not construction.find_subtree(tree, len(cliques) + 99)
    for c in range(len(cliques) + len(seps) + 3):
        assert construction.find_subtree(tree, c) == \
            jax_construction.find_subtree(tree, c)


def test_config_apply():
    try:
        Config(matmul_precision="default").apply()
        assert semirings.get_matmul_precision() == "default"
        Config().apply()
        assert semirings.get_matmul_precision() == "highest"
        with pytest.raises(ValueError, match="precision"):
            semirings.set_matmul_precision("fastest")
    finally:
        semirings.set_matmul_precision("highest")
    # the fields the JAX Config shares with the port, at the same defaults
    ours, theirs = Config(), JaxConfig()
    for key in ("semiring", "matmul_precision", "heuristic", "backend", "root",
                "autotune", "escalate_min_states", "storage_dtype",
                "distribute_division"):
        assert getattr(ours, key) == getattr(theirs, key), key


def test_config_compile_and_engine():
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=3)
    cfg = Config(semiring="log_sum_exp", heuristic="portfolio4")
    assert cfg.compile(factors, sizes).to_json() == JaxConfig(
        heuristic="portfolio4").compile(factors, sizes).to_json()
    eng = cfg.engine(factors, sizes, values, device="cpu")
    assert eng.semiring.name == "log_sum_exp" and eng.device == CPU
    post, logz = eng.posterior_batch({})
    (z,) = brute_force_marginals(factors, sizes, values, [[]])
    np.testing.assert_allclose(float(logz[0]), np.log(z), rtol=1e-5)
    jpost, jlogz = JaxConfig(semiring="log_sum_exp", heuristic="portfolio4").engine(
        factors, sizes, values).posterior_batch({})
    np.testing.assert_allclose(float(logz[0]), float(np.asarray(jlogz)[0]), rtol=1e-5)
    f64 = Config(storage_dtype="float64", root=1).engine(
        factors, sizes, values, device="cpu")
    assert f64.dtype == torch.float64 and f64.plan.tree.root == 1


def test_apply_evidence_slicing():
    from junctiontree_tpu.evidence import apply_evidence as jax_apply
    from junctiontree_tpu_torch.evidence import apply_evidence, shrink_sizes

    factors = [["a", "b"], ["b", "c"], []]
    sizes = {"a": 2, "b": 3, "c": 4}
    rng = np.random.default_rng(0)
    values = [rng.random((2, 3)), rng.random((3, 4)), np.array(1.5)]
    ev = {"b": 2}
    out = apply_evidence(values, factors, ev)
    assert out[0].shape == (2, 1)
    assert out[1].shape == (1, 4)
    np.testing.assert_allclose(out[0][:, 0], values[0][:, 2])
    np.testing.assert_allclose(out[1][0], values[1][2])
    assert out[2].shape == ()
    assert shrink_sizes(sizes, ev) == {"a": 2, "b": 1, "c": 4}
    assert shrink_sizes(sizes, ev) == jt_jax.shrink_sizes(sizes, ev)
    for a, b in zip(out, jax_apply(values, factors, ev)):
        np.testing.assert_array_equal(a, b)
    # the sliced graph runs through the port and gives the evidence's joint
    sliced = jt.create_junction_tree(factors[:2], shrink_sizes(sizes, ev))
    z = sliced.propagate(out[:2], device="cpu")
    (want,) = brute_force_marginals(factors[:2], sizes, values[:2], [["a", "b"]],
                                    evidence=ev)
    np.testing.assert_allclose(z[0][:, 0], want[:, 2], rtol=1e-9)


def test_phase_timers():
    t = PhaseTimers()
    with t.phase("compile"):
        pass
    with t.phase("compile"):
        pass
    rep = t.report()
    assert t.counts["compile"] == 2
    assert rep["compile"] >= 0


def test_device_trace_writes_a_trace(tmp_path):
    """``device_trace`` (``torch.profiler`` in place of ``jax.profiler``)
    writes a Chrome trace that names the ops run inside it."""
    factors, sizes = grid_mrf(2, 2)
    values = random_values(factors, sizes, seed=5)
    eng = jt.create_junction_tree(factors, sizes).engine(device="cpu")
    path = tmp_path / "trace" / "step.json"
    with device_trace(str(path)):
        eng.set_potentials(values).posterior_batch({})
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("einsum" in n or "mul" in n for n in names)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_set_potentials_host_dtype(dtype):
    """``set_potentials(values, dtype=)`` evaluates the potentials on the
    host in ``dtype``, as the JAX engine does."""
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=8)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(
        values, dtype=dtype)
    jeng = jt_jax.create_junction_tree(factors, sizes).engine().set_potentials(
        values, dtype=dtype)
    for a, b in zip(eng._pots_np, jeng._pots_np):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_array_equal(a, b)
    post, logz = eng.posterior_batch({})
    jpost, jlogz = jeng.posterior_batch({})
    # the JAX engine then serves float32 potentials in float32
    np.testing.assert_allclose(logz.numpy(), np.asarray(jlogz),
                               rtol=1e-9 if dtype is np.float64 else 1e-6)


def test_query_batch_vmap_matches_jax_and_query_batch():
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=9)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    jeng = jt_jax.create_junction_tree(factors, sizes).engine().set_potentials(values)
    labels = list(sizes)
    evs = [{labels[0]: 1, labels[4]: 0}, {labels[8]: 1}, {}, {labels[2]: 1}]
    masks = jt.batch_masks(tree.plan, evs)
    margs, z = eng.query_batch_vmap(masks)
    jmargs, jz = jeng.query_batch_vmap([np.asarray(m, np.float64) for m in masks])
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-9)
    for a, b in zip(margs, jmargs):
        assert tuple(a.shape) == (len(evs), b.shape[1])
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)
    qm, qz = eng.query_batch(masks)
    np.testing.assert_allclose(z.numpy(), qz.numpy(), rtol=1e-9)


def test_matmul_precision_is_pinned_and_restored():
    """Every product the package takes runs at the package's precision
    ("highest": TF32 off), whatever the process set, and the caller's
    setting is back afterwards."""
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=10)
    eng = jt.create_junction_tree(factors, sizes).engine(device="cpu")
    seen = []
    real = torch.einsum

    def spy(*a, **k):
        seen.append(torch.get_float32_matmul_precision())
        return real(*a, **k)

    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        torch.einsum = spy
        eng.set_potentials(values).posterior_batch({})
        assert seen and set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "high"
        seen.clear()
        semirings.set_matmul_precision("default")
        torch.set_float32_matmul_precision("highest")
        eng.posterior_batch({})
        assert set(seen) == {"high"}
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.einsum = real
        semirings.set_matmul_precision("highest")
        torch.set_float32_matmul_precision(saved)


def test_matmul_precision_pin_holds_across_threads():
    """The pin is counted across threads: one thread leaving its context
    while another is inside keeps the package's precision in force, the
    last to leave restores the caller's, and products served from two
    threads at once all run at "highest" and equal the JAX package's
    posteriors (float64, rtol 1e-9)."""
    import threading

    saved = torch.get_float32_matmul_precision()
    inside, left = threading.Event(), threading.Event()
    flags = {}

    def first():
        with semirings.pinned_precision():
            inside.set()
            left.wait(5)
        flags["after_first_left"] = torch.get_float32_matmul_precision()

    try:
        torch.set_float32_matmul_precision("high")
        t = threading.Thread(target=first)
        t.start()
        assert inside.wait(5)
        with semirings.pinned_precision():
            left.set()
            t.join(5)
            flags["second_inside"] = torch.get_float32_matmul_precision()
        assert flags == {"after_first_left": "highest",
                         "second_inside": "highest"}
        assert torch.get_float32_matmul_precision() == "high"

        factors, sizes = grid_mrf(3, 3)
        values = random_values(factors, sizes, seed=11)
        tree = jt.create_junction_tree(factors, sizes)
        eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
        jeng = jt_jax.create_junction_tree(factors, sizes).engine().set_potentials(
            values)
        labels = list(sizes)
        evs = [{labels[0]: 1}, {labels[5]: 0, labels[8]: 1}]
        masks = jt.batch_masks_sparse(tree.plan, evs)
        jpost, jlogz = jeng.posterior_batch(masks)
        seen, results = [], []
        real = torch.einsum

        def spy(*a, **k):
            seen.append(torch.get_float32_matmul_precision())
            return real(*a, **k)

        def serve():
            for _ in range(20):
                results.append(eng.posterior_batch(masks))

        torch.einsum = spy
        try:
            threads = [threading.Thread(target=serve) for _ in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
        finally:
            torch.einsum = real
        assert len(results) == 40 and seen and set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "high"
        for post, logz in results:
            np.testing.assert_allclose(logz.numpy(), np.asarray(jlogz), rtol=1e-9)
            for a, b in zip(post, jpost):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-9, atol=1e-12)
    finally:
        torch.set_float32_matmul_precision(saved)
