"""The port's MAP decoding (``map_executor.tree_map_program``, the chain
Viterbi loop, ``Engine.map_assignment(_batch)``, ``score_assignment``)
against the JAX package on the same models and evidence, and against
exhaustive enumeration.

Both packages run in float64 on the CPU.  Tolerances: scores rtol 1e-9
between the packages, rtol 1e-5 against the enumeration (as
``tests/test_map.py``).  Assignments are compared index for index only on
seeded models without ties; under ties each returned assignment is held to
``score_assignment`` and to the enumeration instead, because torch's
``max`` / ``topk`` and JAX's ``argmax`` / ``top_k`` may pick different
winners among equals."""

import itertools

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.models import chain_bn_model, grid_mrf_model

from .util import chain_bn, grid_mrf, random_factor_graph, random_values

SCORE_RTOL = 1e-9


def exhaustive_map(factors, sizes, values, evidence=None):
    var_list = list(sizes)
    best, best_score = None, -np.inf
    for states in itertools.product(*(range(sizes[v]) for v in var_list)):
        a = dict(zip(var_list, states))
        if evidence and any(a[k] != v for k, v in evidence.items()):
            continue
        score = 0.0
        ok = True
        for f, val in zip(factors, values):
            x = float(np.asarray(val)[tuple(a[v] for v in f)])
            if x <= 0:
                ok = False
                break
            score += np.log(x)
        if ok and score > best_score:
            best, best_score = a, score
    return best, best_score


def engines(factors, sizes, values, semiring="max_product"):
    """(port engine, JAX engine, port tree) on the same model, float64."""
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(
        semiring, device="cpu", dtype=torch.float64
    ).set_potentials(values)
    ref = jt_jax.create_junction_tree(factors, sizes).engine(
        semiring
    ).set_potentials(values)
    return eng, ref, tree


def one_hot_log_masks(label, states, size=2):
    m = np.full((len(states), size), -np.inf, dtype=np.float32)
    for b, s in enumerate(states):
        m[b, s] = 0.0
    return {label: m}


def decoded(tree, row):
    return {
        tree.plan.table.label_of(v): int(row[v])
        for v in range(tree.plan.num_vars)
    }


@pytest.mark.parametrize("seed", range(6))
def test_map_matches_exhaustive_and_jax(seed):
    factors, sizes = random_factor_graph(seed + 200, n_vars=6, n_factors=8, max_card=3)
    values = random_values(factors, sizes, seed=seed)
    eng, ref, _ = engines(factors, sizes, values)
    got, got_score = eng.map_assignment()
    want, want_score = exhaustive_map(factors, sizes, values)
    np.testing.assert_allclose(got_score, want_score, rtol=1e-5)
    ref_assign, ref_score = ref.map_assignment()
    np.testing.assert_allclose(got_score, ref_score, rtol=SCORE_RTOL)
    # random potentials: no ties, so the assignments agree too
    assert got == ref_assign == want
    np.testing.assert_allclose(eng.score_assignment(got), got_score, rtol=1e-9)
    np.testing.assert_allclose(
        eng.score_assignment(got), ref.score_assignment(got), rtol=1e-12
    )


def test_map_with_evidence():
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=9)
    eng, ref, _ = engines(factors, sizes, values)
    ev = {"g0_0": 1, "g1_2": 0}
    got, got_score = eng.map_assignment(ev)
    assert got["g0_0"] == 1 and got["g1_2"] == 0
    want, want_score = exhaustive_map(factors, sizes, values, evidence=ev)
    np.testing.assert_allclose(got_score, want_score, rtol=1e-5)
    np.testing.assert_allclose(got_score, ref.map_assignment(ev)[1], rtol=SCORE_RTOL)
    assert got == want


def test_map_with_ties():
    """All-equal potentials: every assignment ties; decoding must still
    return a consistent assignment attaining the max score (held to the
    enumeration, not to the JAX package's indices)."""
    factors, sizes = chain_bn(4)
    values = [np.ones(tuple(sizes[v] for v in f)) for f in factors]
    eng, ref, _ = engines(factors, sizes, values)
    got, score = eng.map_assignment()
    np.testing.assert_allclose(score, 0.0, atol=1e-12)
    np.testing.assert_allclose(score, ref.map_assignment()[1], atol=1e-12)
    assert set(got) == set(sizes)
    assert eng.score_assignment(got) == 0.0
    assert exhaustive_map(factors, sizes, values)[1] == 0.0


def test_map_from_sum_product_engine():
    """map_assignment on a sum-product engine builds the max-product
    sibling; its potentials are log(max(p, 1e-300)) taken in float64."""
    factors, sizes = chain_bn(5)
    values = random_values(factors, sizes, seed=3)
    values[1] = values[1].copy()
    values[1][0, 0] = 0.0  # a structural zero: floored at log(1e-300)
    eng, ref, _ = engines(factors, sizes, values, semiring="sum_product")
    got, score = eng.map_assignment()
    want, want_score = exhaustive_map(factors, sizes, values)
    np.testing.assert_allclose(score, want_score, rtol=1e-5)
    np.testing.assert_allclose(score, ref.map_assignment()[1], rtol=SCORE_RTOL)
    sib = eng._max_delegate()
    assert sib is eng._max_delegate() and sib.semiring == jt.MAX_PRODUCT
    for p, q in zip(sib._pots_np, ref._max_delegate()._pots_np):
        np.testing.assert_allclose(p, q, rtol=1e-12)
    assert min(float(p.min()) for p in sib._pots_np) == pytest.approx(
        np.log(1e-300)
    )
    # new potentials drop the sibling
    eng.set_potentials(random_values(factors, sizes, seed=4))
    assert eng._max_engine is None


@pytest.mark.parametrize("card,n", [(2, 6), (3, 5)])
def test_chain_viterbi_matches_exhaustive_and_jax(card, n):
    """Chains route through the Viterbi loop."""
    factors, sizes, values = chain_bn_model(n, card=card, seed=n + card)
    eng, ref, _ = engines(factors, sizes, values)
    assert eng._chain_layout() is not None
    got, score = eng.map_assignment({"x1": 0})
    assert ("viterbi",) in eng._programs
    assert got["x1"] == 0
    want, want_score = exhaustive_map(factors, sizes, values, evidence={"x1": 0})
    np.testing.assert_allclose(score, want_score, rtol=1e-5)
    ref_assign, ref_score = ref.map_assignment({"x1": 0})
    np.testing.assert_allclose(score, ref_score, rtol=SCORE_RTOL)
    assert got == ref_assign == want
    # Viterbi returns an actual argmax assignment: verify by scoring
    np.testing.assert_allclose(eng.score_assignment(got), want_score, rtol=1e-5)


def test_long_chain_viterbi():
    """1,500 variables: the Viterbi loop against the JAX scan."""
    factors, sizes, values = chain_bn_model(1500, seed=2)
    eng, ref, _ = engines(factors, sizes, values)
    got, score = eng.map_assignment()
    assert len(got) == 1500 and np.isfinite(score)
    ref_assign, ref_score = ref.map_assignment()
    np.testing.assert_allclose(score, ref_score, rtol=SCORE_RTOL)
    np.testing.assert_allclose(eng.score_assignment(got), score, rtol=1e-9)
    assert got == ref_assign


def test_viterbi_equals_tree_program_on_a_chain():
    """The two MAP programs of the port on one chain: equal scores, and
    each assignment attains its score."""
    from junctiontree_tpu_torch.map_executor import tree_map_program

    factors, sizes, values = chain_bn_model(40, card=3, seed=6)
    eng, _, tree = engines(factors, sizes, values)
    masks = one_hot_log_masks("x7", [0, 1, 2, 1], size=3)
    a_chain, s_chain = eng.map_assignment_batch(masks)
    ids = (tree.plan.table.id_of("x7"),)
    a_tree, s_tree = tree_map_program(tree.plan, ids)(
        eng._pots, [torch.as_tensor(masks["x7"], dtype=torch.float64)]
    )
    np.testing.assert_allclose(s_chain.numpy(), s_tree.numpy(), rtol=1e-12)
    assert a_chain.dtype == a_tree.dtype == torch.int32
    np.testing.assert_array_equal(a_chain.numpy(), a_tree.numpy())


def test_map_assignment_batch_chain():
    factors, sizes, values = chain_bn_model(8, seed=4)
    eng, ref, tree = engines(factors, sizes, values, semiring="sum_product")
    states = [0, 1, 0]
    masks = one_hot_log_masks("x3", states)
    assigns, scores = eng.map_assignment_batch(masks)
    ref_assigns, ref_scores = ref.map_assignment_batch(masks)
    assert tuple(assigns.shape) == (3, 8) and assigns.dtype == torch.int32
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=SCORE_RTOL)
    np.testing.assert_array_equal(assigns.numpy(), np.asarray(ref_assigns))
    vid = tree.plan.table.id_of("x3")
    for b, s in enumerate(states):
        assert assigns[b, vid] == s
        _, want_score = exhaustive_map(factors, sizes, values, evidence={"x3": s})
        np.testing.assert_allclose(scores[b], want_score, rtol=1e-5)


def test_map_assignment_batch_general_tree():
    """Batched MAP on a non-chain plan: backpointer traceback, verified
    against exhaustive enumeration and the JAX package, and decoded
    assignments attain their scores (consistency)."""
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=1)
    eng, ref, tree = engines(factors, sizes, values, semiring="sum_product")
    assert eng._chain_layout() is None
    states = [0, 1, 0, 1]
    masks = one_hot_log_masks("g0_1", states)
    assigns, scores = eng.map_assignment_batch(masks)
    ref_assigns, ref_scores = ref.map_assignment_batch(masks)
    assert tuple(assigns.shape) == (4, len(sizes)) and assigns.dtype == torch.int32
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=SCORE_RTOL)
    np.testing.assert_array_equal(assigns.numpy(), np.asarray(ref_assigns))
    vid = tree.plan.table.id_of("g0_1")
    for b, s in enumerate(states):
        assert assigns[b, vid] == s
        _, want_score = exhaustive_map(factors, sizes, values, evidence={"g0_1": s})
        np.testing.assert_allclose(scores[b], want_score, rtol=1e-5)
        np.testing.assert_allclose(
            eng.score_assignment(decoded(tree, assigns[b])), want_score, rtol=1e-5
        )


def test_map_assignment_batch_general_tree_ties():
    """Uniform potentials on a grid: the traceback must still produce a
    consistent (score-attaining) assignment for every batch element."""
    factors, sizes = grid_mrf(2, 2)
    values = [np.ones(tuple(sizes[v] for v in f)) for f in factors]
    eng, ref, tree = engines(factors, sizes, values)
    assigns, scores = eng.map_assignment_batch({})
    np.testing.assert_allclose(scores.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(
        scores.numpy(), np.asarray(ref.map_assignment_batch({})[1]), atol=1e-12
    )
    assert eng.score_assignment(decoded(tree, assigns[0])) == 0.0


def test_map_infeasible_evidence_batch():
    """A mask forbidding every state scores about -1e30 (below -1e29, the
    contract for "no feasible assignment"), not -inf and not NaN, in both
    packages; a feasible row beside it is untouched."""
    factors, sizes = grid_mrf(2, 2)
    values = random_values(factors, sizes, seed=2)
    eng, ref, _ = engines(factors, sizes, values)
    m = np.full((2, 2), -np.inf, dtype=np.float32)
    m[1, 0] = 0.0
    assigns, scores = eng.map_assignment_batch({"g0_0": m})
    _, ref_scores = ref.map_assignment_batch({"g0_0": m})
    assert -1.1e30 < float(scores[0]) < -1e29
    assert -1.1e30 < float(ref_scores[0]) < -1e29
    assert not torch.isnan(scores).any()
    np.testing.assert_allclose(float(scores[1]), float(ref_scores[1]), rtol=SCORE_RTOL)
    _, want = exhaustive_map(factors, sizes, values, evidence={"g0_0": 0})
    np.testing.assert_allclose(float(scores[1]), want, rtol=1e-5)
    # a chain has no clamp: its infeasible row is -inf (below -1e29 too)
    cf, cs, cv = chain_bn_model(5, seed=1)
    ceng, cref, _ = engines(cf, cs, cv)
    dead = {"x2": np.full((1, 2), -np.inf, dtype=np.float32)}
    assert float(ceng.map_assignment_batch(dead)[1][0]) < -1e29
    assert float(np.asarray(cref.map_assignment_batch(dead)[1])[0]) < -1e29


@pytest.mark.parametrize("model", ["grid", "chain"])
def test_map_assignment_batch_chunked_matches_unchunked(model):
    """map_assignment_batch(chunk=) serves row slices (the last one
    shorter, nothing padded); assignments and scores equal the unchunked
    call and the JAX package's chunked call.  A chain keeps the Viterbi
    loop under ``chunk=``."""
    if model == "grid":
        factors, sizes, values = grid_mrf_model(4, 4, seed=9)
    else:
        factors, sizes, values = chain_bn_model(16, card=3, seed=9)
    eng, ref, _ = engines(factors, sizes, values)
    names = list(sizes)
    B = 7  # not a multiple of chunk=3
    rng = np.random.default_rng(4)
    masks = {}
    for v in (names[0], names[10]):
        m = np.full((B, sizes[v]), -np.inf, dtype=np.float32)
        m[np.arange(B), rng.integers(0, sizes[v], B)] = 0.0
        masks[v] = m
    a_want, s_want = eng.map_assignment_batch(masks)
    a_got, s_got = eng.map_assignment_batch(masks, chunk=3)
    assert torch.equal(s_got, s_want) and torch.equal(a_got, a_want)
    a_ref, s_ref = ref.map_assignment_batch(masks, chunk=3)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_ref), rtol=SCORE_RTOL)
    np.testing.assert_array_equal(a_got.numpy(), np.asarray(a_ref))
    # B <= chunk degenerates to the plain path
    a2, s2 = eng.map_assignment_batch(masks, chunk=64)
    assert torch.equal(s2, s_want) and torch.equal(a2, a_want)
    want_prog = ("viterbi",) if model == "chain" else "tree_map"
    assert any(k == want_prog or k[0] == want_prog for k in eng._programs)
    assert (model == "chain") == (
        not any(k[0] == "tree_map" for k in eng._programs)
    )
    with pytest.raises(ValueError):
        eng.map_assignment_batch(masks, chunk=0)


def test_tree_map_keeps_evidence_free_cliques_unbatched():
    """A clique without evidence keeps a batch axis of 1 (its scores and
    backpointers are shared by the batch); forbidden states are clamped at
    -1e30, so a masked potential is never NaN."""
    from junctiontree_tpu_torch import map_executor

    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=5)
    eng, _, tree = engines(factors, sizes, values)
    plan = tree.plan
    v = plan.clique_vars[0][0]
    mask = torch.full((3, 2), -float("inf"), dtype=torch.float64)
    free = map_executor._masked_potential(plan, 0, eng._pots, [mask], {v: 0}, [])
    held = map_executor._masked_potential(plan, 0, eng._pots, [mask], {v: 0}, [v])
    assert free.shape[0] == 1 and held.shape[0] == 3
    assert map_executor._NEG == -1e30
    assert float(held.max()) < -1e29 and not torch.isnan(held).any()
