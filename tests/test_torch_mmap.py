"""``junctiontree_tpu_torch.mmap`` case for case with ``tests/test_mmap.py``.

Each case runs the port in float64 against the brute-force oracle (score
abs 1e-9; the decoded assignment must attain the optimum, ties may differ)
and in float32 against the JAX package's float32 program on the same inputs
(scores abs 2e-5: two float32 logsumexp chains in another order).  The host
side (constrained orders, bucket trees) is a copy and is held equal."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu import mmap as jmmap
from junctiontree_tpu_torch import MarginalMapSolver, marginal_map
from junctiontree_tpu_torch.labels import intern_factors
from junctiontree_tpu_torch.mmap import build_bucket_tree, constrained_order

from .util import brute_force_marginals, grid_mrf, random_factor_graph, random_values


def _oracle_mmap(factors, sizes, values, map_vars, evidence=None):
    marg = brute_force_marginals(
        factors, sizes, values, [list(map_vars)], evidence
    )[0]
    return float(marg.max()), marg


def _check(factors, sizes, values, map_vars, evidence=None):
    best, marg = _oracle_mmap(factors, sizes, values, map_vars, evidence)
    solver = MarginalMapSolver(factors, sizes, map_vars, device="cpu",
                               dtype=torch.float64).set_potentials(values)
    assign, score = solver.query(evidence)
    assert score == pytest.approx(np.log(best), abs=1e-9)
    assert marg[tuple(assign[v] for v in map_vars)] == pytest.approx(best, rel=1e-9)
    # float32, beside the JAX package
    a32, s32 = marginal_map(factors, values, sizes, map_vars, evidence, device="cpu")
    ja, js = jmmap.marginal_map(factors, values, sizes, map_vars, evidence)
    assert s32 == pytest.approx(js, abs=2e-5)
    assert marg[tuple(a32[v] for v in map_vars)] == pytest.approx(best, rel=1e-5)


def test_simple_chain():
    factors = [["a", "b"], ["b", "c"], ["c", "d"]]
    sizes = {"a": 2, "b": 3, "c": 2, "d": 4}
    values = random_values(factors, sizes, seed=0)
    _check(factors, sizes, values, ["a", "d"])
    _check(factors, sizes, values, ["b"])
    _check(factors, sizes, values, ["a", "c"], evidence={"d": 2})


@pytest.mark.parametrize("seed", range(6))
def test_random_graphs(seed):
    factors, sizes = random_factor_graph(seed, n_vars=7, n_factors=9)
    values = random_values(factors, sizes, seed=seed + 100)
    rng = np.random.default_rng(seed)
    all_vars = sorted({v for f in factors for v in f})
    k = int(rng.integers(1, len(all_vars)))
    map_vars = list(rng.choice(all_vars, size=k, replace=False))
    _check(factors, sizes, values, map_vars)
    rest = [v for v in all_vars if v not in map_vars]
    if rest:
        _check(factors, sizes, values, map_vars,
               evidence={rest[0]: sizes[rest[0]] - 1})


def test_all_map_vars_equals_mpe():
    factors, sizes = random_factor_graph(3, n_vars=6, n_factors=8)
    values = random_values(factors, sizes, seed=7)
    all_vars = sorted({v for f in factors for v in f})
    solver = MarginalMapSolver(factors, sizes, all_vars, device="cpu",
                               dtype=torch.float64).set_potentials(values)
    assign, score = solver.query()
    eng = jt.Engine(jt.compile_plan(factors, sizes), device="cpu",
                    dtype=torch.float64).set_potentials(values)
    a2, s2 = eng.map_assignment()
    assert score == pytest.approx(s2, abs=1e-9)
    assert eng.score_assignment(assign) == pytest.approx(s2, abs=1e-9)


def test_no_map_vars_equals_logz():
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 2, "c": 3}
    values = random_values(factors, sizes, seed=1)
    assign, score = marginal_map(factors, values, sizes, [], device="cpu")
    assert assign == {}
    z = brute_force_marginals(factors, sizes, values, [[]])[0]
    assert score == pytest.approx(np.log(float(z)), abs=1e-5)
    assert score == pytest.approx(
        jmmap.marginal_map(factors, values, sizes, [])[1], abs=2e-5)


def test_structural_zeros():
    factors = [["a"], ["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 2, "c": 2}
    values = [
        np.array([0.4, 0.6]),
        np.array([[1.0, 0.0], [0.0, 1.0]]),
        np.array([[0.9, 0.1], [0.2, 0.8]]),
    ]
    _check(factors, sizes, values, ["b"])
    _check(factors, sizes, values, ["c"], evidence={"a": 1})


def test_forest_components_and_scalar_factor():
    factors = [["a", "b"], ["c", "d"], []]
    sizes = {"a": 2, "b": 3, "c": 2, "d": 2}
    values = [
        np.abs(np.random.default_rng(0).normal(size=(2, 3))) + 0.1,
        np.abs(np.random.default_rng(1).normal(size=(2, 2))) + 0.1,
        np.array(2.5),
    ]
    assign, score = marginal_map(factors, values, sizes, ["a", "d"], device="cpu")
    marg = brute_force_marginals(factors[:2], sizes, values[:2], [["a", "d"]])[0]
    assert score == pytest.approx(np.log(marg.max()) + np.log(2.5), abs=1e-5)
    assert marg[assign["a"], assign["d"]] == pytest.approx(marg.max(), rel=1e-6)
    assert score == pytest.approx(
        jmmap.marginal_map(factors, values, sizes, ["a", "d"])[1], abs=2e-5)


def test_batched_masks_and_infeasible_row():
    factors = [["a", "b"], ["b", "c"], ["c", "d"]]
    sizes = {"a": 2, "b": 2, "c": 2, "d": 3}
    values = random_values(factors, sizes, seed=5)
    solver = MarginalMapSolver(factors, sizes, ["a", "c"], device="cpu")
    solver.set_potentials(values)
    NEG = -1e30
    mask = np.zeros((4, sizes["d"]), dtype=np.float32)
    mask[0, :] = [0, NEG, NEG]
    mask[1, :] = [NEG, 0, NEG]
    mask[3, :] = -np.inf  # no state allowed
    assign, scores = solver.query_batch({"d": mask})
    assert assign.dtype == torch.int32 and tuple(assign.shape) == (4, 2)
    assign, scores = assign.numpy(), scores.numpy()
    for b, ev in enumerate([{"d": 0}, {"d": 1}, None]):
        best, marg = _oracle_mmap(factors, sizes, values, ["a", "c"], ev)
        assert scores[b] == pytest.approx(np.log(best), abs=1e-5)
        assert marg[assign[b, 0], assign[b, 1]] == pytest.approx(best, rel=1e-6)
    # the contract of the MAP programs: below -1e29, never NaN
    assert scores[3] < -1e29 and not np.isnan(scores).any()
    jsolver = jmmap.MarginalMapSolver(factors, sizes, ["a", "c"]).set_potentials(values)
    _, jscores = jsolver.query_batch({"d": mask[:3]})
    np.testing.assert_allclose(scores[:3], np.asarray(jscores), atol=2e-5)


def test_constrained_order_and_validity():
    factors, sizes = random_factor_graph(11, n_vars=8, n_factors=10)
    all_vars = sorted({v for f in factors for v in f})
    table, ifac, isiz = intern_factors(factors, sizes)
    max_ids = {table.id_of(v) for v in all_vars[:3]}
    order = constrained_order(ifac, isiz, max_ids)
    pos = {v: i for i, v in enumerate(order)}
    sum_pos = [pos[v] for v in range(len(isiz)) if v not in max_ids]
    assert max(sum_pos) < min(pos[v] for v in max_ids)
    bt = build_bucket_tree(ifac, isiz, order)
    for q in max_ids:
        p = bt.parent[q]
        while p >= 0:
            assert p in max_ids
            p = bt.parent[p]
    for h in ("min_fill", "min_degree", "min_weight"):
        got = constrained_order(ifac, isiz, max_ids, heuristic=h)
        assert got == jmmap.constrained_order(ifac, isiz, max_ids, heuristic=h)
        jbt = jmmap.build_bucket_tree(ifac, isiz, got)
        mine = build_bucket_tree(ifac, isiz, got)
        assert (mine.scope, mine.parent, mine.factor_bucket) == (
            jbt.scope, jbt.parent, jbt.factor_bucket)
    with pytest.raises(ValueError, match="heuristic"):
        constrained_order(ifac, isiz, max_ids, heuristic="nope")


def test_grid_mmap():
    factors, sizes = grid_mrf(4, 3)
    values = random_values(factors, sizes, seed=9)
    _check(factors, sizes, values, ["g0_0", "g1_2", "g3_1"])


def test_infeasible_cap_raises():
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 2, "c": 2}
    with pytest.raises(ValueError, match="infeasible"):
        MarginalMapSolver(factors, sizes, ["a"], max_states=2, device="cpu")


@pytest.mark.parametrize("seed", range(6))
def test_portfolio_prefers_feasible(seed):
    factors, sizes = random_factor_graph(seed, n_vars=10, n_factors=14)
    rng = np.random.default_rng(seed)
    map_vars = [
        v for v in sorted({x for f in factors for x in f}, key=str)
        if rng.random() < 0.4
    ] or [factors[0][0]]
    table, ifs, isz = intern_factors(factors, sizes)
    map_ids = {table.id_of(v) for v in map_vars}
    per_h = []
    for h in ("min_fill", "min_degree", "min_weight"):
        order = constrained_order(ifs, isz, map_ids, heuristic=h)
        per_h.append(build_bucket_tree(ifs, isz, order).max_bucket_states(isz))
    cap = min(per_h)
    solver = MarginalMapSolver(factors, sizes, map_vars, max_states=cap,
                               device="cpu", dtype=torch.float64)
    assert solver.bt.max_bucket_states(isz) <= cap
    jsolver = jmmap.MarginalMapSolver(factors, sizes, map_vars, max_states=cap)
    assert solver.bt.order == jsolver.bt.order
    values = random_values(factors, sizes, seed=seed + 100)
    assign, score = solver.set_potentials(values).query()
    best, marg = _oracle_mmap(factors, sizes, values, map_vars)
    assert score == pytest.approx(np.log(best), abs=1e-9)


def test_errors():
    factors = [["a", "b"]]
    sizes = {"a": 2, "b": 2}
    with pytest.raises(ValueError, match="duplicates"):
        MarginalMapSolver(factors, sizes, ["a", "a"], device="cpu")
    with pytest.raises(ValueError, match="'ghost'.*no factor"):
        MarginalMapSolver(factors, sizes, ["a", "ghost"], device="cpu")
    s = MarginalMapSolver(factors, sizes, ["a"], device="cpu")
    with pytest.raises(ValueError, match="set_potentials"):
        s.query()
    with pytest.raises(ValueError, match="shape"):
        s.set_potentials([np.ones((2, 3))])


def test_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    factors, sizes = [["a", "b"]], {"a": 2, "b": 2}
    with pytest.raises(RuntimeError, match="CUDA"):
        MarginalMapSolver(factors, sizes, ["a"])
    with pytest.raises(RuntimeError, match="CUDA"):
        marginal_map(factors, [np.ones((2, 2))], sizes, ["a"])
    with pytest.raises(RuntimeError, match="CUDA"):
        jt.create_junction_tree(factors, sizes).marginal_map([np.ones((2, 2))], ["a"])


def test_soft_evidence_masks():
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 3, "c": 3}
    values = random_values(factors, sizes, seed=12)
    lik = np.array([0.5, 2.0, 0.1])
    solver = MarginalMapSolver(factors, sizes, ["a"], device="cpu")
    solver.set_potentials(values)
    masks = {"c": np.log(lik)[None, :].astype(np.float32)}
    assign, scores = solver.query_batch(masks)
    marg = brute_force_marginals(
        factors + [["c"]], sizes, values + [lik], [["a"]]
    )[0]
    assert float(scores[0]) == pytest.approx(np.log(marg.max()), abs=1e-5)
    assert marg[int(assign[0, 0])] == pytest.approx(marg.max(), rel=1e-6)
    jsolver = jmmap.MarginalMapSolver(factors, sizes, ["a"]).set_potentials(values)
    assert float(scores[0]) == pytest.approx(
        float(np.asarray(jsolver.query_batch(masks)[1])[0]), abs=2e-5)


def test_tree_object_api():
    factors = [["a", "b"], ["b", "c"], ["c", "d"]]
    sizes = {"a": 2, "b": 3, "c": 2, "d": 4}
    values = random_values(factors, sizes, seed=0)
    tree = jt.create_junction_tree(factors, sizes)
    assign, score = tree.marginal_map(values, ["a", "d"], {"b": 1}, device="cpu")
    best, marg = _oracle_mmap(factors, sizes, values, ["a", "d"], {"b": 1})
    assert score == pytest.approx(np.log(best), abs=1e-5)
    assert marg[assign["a"], assign["d"]] == pytest.approx(best, rel=1e-6)
    jassign, jscore = jt_jax.create_junction_tree(factors, sizes).marginal_map(
        values, ["a", "d"], {"b": 1})
    assert score == pytest.approx(jscore, abs=2e-5) and assign == jassign


def test_describe():
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 3, "c": 2}
    values = random_values(factors, sizes, seed=4)
    s = MarginalMapSolver(factors, sizes, ["a"], device="cpu").set_potentials(values)
    d = s.describe()
    assert d["num_vars"] == 3 and d["num_map_vars"] == 1
    assert d["num_buckets"] == 3 and d["max_bucket_states"] >= 2
    assert d["compiled_programs"] == 0
    s.query()
    assert s.describe()["compiled_programs"] == 1
    jd = jmmap.MarginalMapSolver(factors, sizes, ["a"]).describe()
    assert d == jd


def test_uai_and_bif_readers_are_copies():
    """The readers are host code copied from the JAX package: the same text
    parses to the same model, and a written model reads back."""
    from junctiontree_tpu.utils import bif as jbif, uai as juai
    from junctiontree_tpu_torch.utils import bif, uai

    factors = [[0, 1], [1, 2], [2]]
    sizes = {0: 2, 1: 3, 2: 2}
    values = random_values(factors, sizes, seed=3)
    text = uai.write_uai(factors, sizes, values)
    assert text == juai.write_uai(factors, sizes, values)
    f2, s2, v2 = uai.parse_uai(text)
    jf, js, jv = juai.parse_uai(text)
    assert f2 == jf == factors and s2 == js
    for a, b, c in zip(v2, jv, values):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=1e-6)
    assert uai.parse_evidence("2 0 1 2 0") == juai.parse_evidence("2 0 1 2 0") == {0: 1, 2: 0}
    assert uai.parse_query("2 0 2") == juai.parse_query("2 0 2")
    text = """network n { }
variable rain { type discrete [ 2 ] { yes, no }; }
variable wet { type discrete [ 2 ] { yes, no }; }
probability ( rain ) { table 0.2, 0.8; }
probability ( wet | rain ) { (yes) 0.9, 0.1; (no) 0.1, 0.9; }
"""
    got, want = bif.parse_bif(text), jbif.parse_bif(text)
    assert got[0] == want[0] and got[1] == want[1]
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(bif.BifError):
        bif.parse_bif("variable x { type discrete [ 2 ] { a, b }; }\nprobability ( y ) { table 1; }")
    # the parsed network answers Marginal MAP
    assign, _ = marginal_map(got[0], got[2], got[1], ["rain"], {"wet": 0}, device="cpu")
    assert assign == {"rain": 0}
