"""The port's k-best decoding (``map_executor.tree_kbest_program``, the
chain list-Viterbi loop, ``Engine.top_k_assignments(_batch)``) against the
JAX package on the same models and evidence, and against a full enumeration
of ranked assignments.

Both packages run in float64 on the CPU.  Tolerances: scores rtol 1e-9 /
atol 1e-12 between the packages, atol 1e-5 against the enumeration (as
``tests/test_tree_kbest.py``).  ``torch.topk`` promises no order among equal
scores, so each returned assignment is held to the score it reports and the
list to distinctness, never to the JAX package's indices under ties."""

import itertools

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.models import chain_bn_model

from .util import grid_mrf, random_factor_graph, random_values


def brute_ranked(factors, sizes, values, evidence=None, floor=-1e29):
    """All assignments sorted by log unnormalized joint, best first."""
    names = sorted({v for f in factors for v in f}, key=str)
    scored = []
    for combo in itertools.product(*[range(sizes[v]) for v in names]):
        a = dict(zip(names, combo))
        if evidence and any(a[v] != s for v, s in evidence.items()):
            continue
        tot = 0.0
        for f, val in zip(factors, values):
            x = float(np.asarray(val)[tuple(a[v] for v in f)])
            if x <= 0:
                tot = -np.inf
                break
            tot += np.log(x)
        if tot > floor:
            scored.append((tot, a))
    scored.sort(key=lambda t: -t[0])
    return scored


def engines(factors, sizes, values, semiring=jt.MAX_PRODUCT):
    eng = jt.Engine(
        jt.compile_plan(factors, sizes), semiring, device="cpu",
        dtype=torch.float64,
    ).set_potentials(values)
    ref = jt_jax.Engine(
        jt_jax.compile_plan(factors, sizes), jt_jax.SEMIRINGS[semiring.name]
    ).set_potentials(values)
    return eng, ref


def joint_log_score(factors, values, a):
    with np.errstate(divide="ignore"):
        return sum(
            np.log(np.asarray(val)[tuple(a[v] for v in f)])
            for f, val in zip(factors, values)
        )


def check_topk(factors, sizes, values, k, evidence=None, atol=1e-5):
    eng, ref = engines(factors, sizes, values)
    got = eng.top_k_assignments(evidence, k=k)
    want = brute_ranked(factors, sizes, values, evidence)[:k]
    assert len(got) == len(want)
    np.testing.assert_allclose(
        [s for _, s in got], [s for s, _ in want], atol=atol
    )
    ref_got = ref.top_k_assignments(evidence, k=k)
    np.testing.assert_allclose(
        [s for _, s in got], [s for _, s in ref_got], rtol=1e-9, atol=1e-12
    )
    # every returned assignment achieves its reported score, respects the
    # evidence, and the list is distinct
    seen = set()
    for a, s in got:
        assert joint_log_score(factors, values, a) == pytest.approx(s, abs=atol)
        assert eng.score_assignment(a) == pytest.approx(s, abs=1e-9)
        if evidence:
            assert all(a[v] == st for v, st in evidence.items())
        key = tuple(sorted(a.items(), key=str))
        assert key not in seen
        seen.add(key)
    return got, ref_got


@pytest.mark.parametrize("seed", range(5))
def test_random_trees_match_bruteforce_and_jax(seed):
    factors, sizes = random_factor_graph(seed, n_vars=7, n_factors=9)
    values = random_values(factors, sizes, seed=seed + 50)
    got, ref_got = check_topk(factors, sizes, values, k=8)
    # seeded random potentials: no ties, so the ranked assignments agree
    assert [a for a, _ in got] == [a for a, _ in ref_got]


def test_grid_with_evidence():
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=3)
    check_topk(factors, sizes, values, k=6, evidence={"g1_1": 1, "g0_2": 0})


def test_k_exceeds_assignment_count():
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 2, "c": 2}
    values = random_values(factors, sizes, seed=1)
    eng, ref = engines(factors, sizes, values)
    assert eng._chain_layout() is not None  # the chain list-Viterbi loop
    got = eng.top_k_assignments(k=50)
    assert ("kbest", 50) in eng._programs
    want = brute_ranked(factors, sizes, values)
    assert len(got) == len(want) == 8 == len(ref.top_k_assignments(k=50))
    np.testing.assert_allclose(
        [s for _, s in got], [s for s, _ in want], atol=1e-5
    )
    assert len({tuple(sorted(a.items())) for a, _ in got}) == 8


@pytest.mark.parametrize("card,n,k", [(2, 7, 5), (3, 5, 12)])
def test_chain_kbest_matches_bruteforce_and_jax(card, n, k):
    factors, sizes, values = chain_bn_model(n, card=card, seed=n)
    got, ref_got = check_topk(factors, sizes, values, k=k, evidence={"x2": 1})
    assert [a for a, _ in got] == [a for a, _ in ref_got]


def test_first_equals_map_on_tree():
    factors, sizes = grid_mrf(3, 4)
    values = random_values(factors, sizes, seed=7)
    eng, ref = engines(factors, sizes, values)
    (a1, s1), *_ = eng.top_k_assignments(k=4)
    a0, s0 = eng.map_assignment()
    assert s1 == pytest.approx(s0, abs=1e-9) and a1 == a0
    assert s1 == pytest.approx(ref.top_k_assignments(k=4)[0][1], rel=1e-9)


def test_forest_components():
    """Disconnected components joined by empty separators still rank
    exactly."""
    factors = [["a", "b"], ["c", "d"], ["d", "e"]]
    sizes = {"a": 2, "b": 3, "c": 2, "d": 2, "e": 3}
    values = random_values(factors, sizes, seed=9)
    check_topk(factors, sizes, values, k=10)


def test_structural_zeros_feasible_only():
    """Zero potential entries (log -inf) must never appear in the ranked
    list while feasible assignments remain."""
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 2, "c": 2}
    values = random_values(factors, sizes, seed=2)
    values[0][0, 0] = 0.0  # forbid a=0,b=0
    eng, ref = engines(factors, sizes, values)
    got = eng.top_k_assignments(k=8)
    want = brute_ranked(factors, sizes, values)
    assert len(got) == len(want) == 6 == len(ref.top_k_assignments(k=8))
    np.testing.assert_allclose(
        [s for _, s in got], [s for s, _ in want], atol=1e-5
    )
    for a, _ in got:
        assert not (a["a"] == 0 and a["b"] == 0)


@pytest.mark.parametrize("model", ["grid", "chain"])
def test_uniform_potentials_rank_distinct_assignments(model):
    """A tie model: every assignment scores 0.  The k returned must be
    distinct, each scoring 0 under ``score_assignment`` (the oracle here;
    the JAX package's tie order is not the contract), in the batched tree
    program and in the chain loop."""
    if model == "grid":
        factors, sizes = grid_mrf(2, 3)
    else:
        factors = [["a", "b"], ["b", "c"], ["c", "d"]]
        sizes = {"a": 2, "b": 2, "c": 2, "d": 2}
    values = [np.ones(tuple(sizes[v] for v in f)) for f in factors]
    eng, ref = engines(factors, sizes, values)
    assert (eng._chain_layout() is not None) == (model == "chain")
    got = eng.top_k_assignments(k=7)
    assert len(got) == 7 == len(ref.top_k_assignments(k=7))
    assert all(s == 0.0 and eng.score_assignment(a) == 0.0 for a, s in got)
    assert len({tuple(sorted(a.items())) for a, _ in got}) == 7
    assign, scores = eng.top_k_assignments_batch({}, k=7)
    assert assign.dtype == torch.int32
    assert tuple(assign.shape) == (1, 7, len(sizes))
    assert len({tuple(r) for r in assign[0].tolist()}) == 7
    assert (scores == 0).all()


def test_batched_masks():
    """top_k_assignments_batch ranks per batch element under per-element
    evidence masks."""
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=11)
    eng, ref = engines(factors, sizes, values)
    B, k = 3, 5
    m = np.zeros((B, 2), dtype=np.float32)
    m[0] = [0.0, -np.inf]     # g0_0 = 0
    m[1] = [-np.inf, 0.0]     # g0_0 = 1
    # row 2: unobserved
    assign, scores = eng.top_k_assignments_batch({"g0_0": m}, k=k)
    ref_assign, ref_scores = ref.top_k_assignments_batch({"g0_0": m}, k=k)
    assert assign.dtype == torch.int32 and tuple(assign.shape) == (B, k, 9)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=1e-9)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ref_assign))
    assign, scores = assign.numpy(), scores.numpy()
    plan = eng.plan
    for b, ev in enumerate([{"g0_0": 0}, {"g0_0": 1}, None]):
        want = brute_ranked(factors, sizes, values, ev)[:k]
        np.testing.assert_allclose(scores[b], [s for s, _ in want], atol=1e-5)
        assert (np.diff(scores[b]) <= 0).all()
        for r, (ws, _) in enumerate(want):
            a = {
                plan.table.label_of(v): int(assign[b, r, v])
                for v in range(plan.num_vars)
            }
            assert joint_log_score(factors, values, a) == pytest.approx(ws, abs=1e-5)


def test_batched_infeasible_tail():
    """Evidence that leaves fewer than k feasible assignments: the tail of
    the batched result scores below -1e29 (about -1e30, never NaN), and the
    unbatched call drops it, in both packages."""
    factors = [["a", "b"], ["b", "c"], ["a", "c"]]
    sizes = {"a": 2, "b": 2, "c": 2}
    values = random_values(factors, sizes, seed=6)
    eng, ref = engines(factors, sizes, values)
    assert eng._chain_layout() is None
    ev = {"a": 0, "b": 1}
    got = eng.top_k_assignments(ev, k=5)
    assert len(got) == 2 == len(ref.top_k_assignments(ev, k=5))
    masks = {
        v: np.where(np.arange(2)[None] == s, 0.0, -np.inf).astype(np.float32)
        for v, s in ev.items()
    }
    _, scores = eng.top_k_assignments_batch(masks, k=5)
    _, ref_scores = ref.top_k_assignments_batch(masks, k=5)
    scores, ref_scores = scores.numpy()[0], np.asarray(ref_scores)[0]
    assert not np.isnan(scores).any()
    assert ((scores < -1e29) == (ref_scores < -1e29)).all()
    assert (scores[2:] < -1e29).all() and (scores[:2] > -1e29).all()
    np.testing.assert_allclose(scores[:2], ref_scores[:2], rtol=1e-9)


def test_sum_engine_delegates():
    """A sum-product engine delegates k-best to its max-product sibling."""
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=4)
    eng, ref = engines(factors, sizes, values, semiring=jt.SUM_PRODUCT)
    got = eng.top_k_assignments(k=3)
    want = brute_ranked(factors, sizes, values)[:3]
    np.testing.assert_allclose(
        [s for _, s in got], [s for s, _ in want], atol=1e-5
    )
    np.testing.assert_allclose(
        [s for _, s in got], [s for _, s in ref.top_k_assignments(k=3)], rtol=1e-9
    )


def test_integer_labels_resolve_through_table():
    """Variable labels may be ints; mask keys must resolve through the
    label table, not be taken as raw var ids."""
    factors = [[10, 20], [20, 30], [10, 30]]
    sizes = {10: 2, 20: 2, 30: 2}
    values = random_values(factors, sizes, seed=5)
    eng, _ = engines(factors, sizes, values)
    got = eng.top_k_assignments({30: 1}, k=3)
    want = brute_ranked(factors, sizes, values, {30: 1})[:3]
    np.testing.assert_allclose(
        [s for _, s in got], [s for s, _ in want], atol=1e-5
    )
    assert all(a[30] == 1 for a, _ in got)
    m = np.array([[-np.inf, 0.0]], dtype=np.float32)
    _, scores = eng.top_k_assignments_batch({30: m}, k=3)
    np.testing.assert_allclose(
        scores.numpy()[0], [s for s, _ in want], atol=1e-5
    )
    a, s = eng.map_assignment({30: 1})
    assert a[30] == 1 and s == pytest.approx(want[0][0], abs=1e-5)


def test_k_below_one_raises():
    factors, sizes = grid_mrf(2, 2)
    eng, _ = engines(factors, sizes, random_values(factors, sizes, seed=0))
    with pytest.raises(ValueError):
        eng.top_k_assignments_batch({}, k=0)
