"""The port's tree surgery (``surgery.py``, the ``JunctionTree`` methods on
it) and live-engine edits (``Engine.multiply_factor``) against the JAX
package's on the same inputs, and against the brute-force oracle.

``surgery.py`` is host code copied from the JAX package, so its plans are
held to the JAX package's ``Plan.to_json()`` string for string and its
nested trees to equality.  Engines run in float64 on the CPU: rtol 1e-9
between the packages, rtol 1e-6 against the oracle (as
``tests/test_surgery.py``)."""

import itertools

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu.surgery as jax_surgery
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch import surgery
from junctiontree_tpu_torch.models import chain_bn_model, grid_mrf_model

from .util import brute_force_marginals, check_running_intersection


def edge_set(tree):
    """Canonical undirected edge set {(frozenset{a,b}, sep)} of a nested
    tree (orientation-independent: reroots must preserve it)."""
    out = set()
    stack = [tree]
    while stack:
        node = stack.pop()
        for sep, sub in node[1:]:
            out.add((frozenset((node[0], sub[0])), sep))
            stack.append(sub)
    return out


def plans(factors, sizes):
    return jt.compile_plan(factors, sizes), jt_jax.compile_plan(factors, sizes)


def engine(plan, values, semiring=jt.SUM_PRODUCT):
    return jt.Engine(
        plan, semiring, device="cpu", dtype=torch.float64
    ).set_potentials(values)


def check_propagate(plan, factors, sizes, values):
    marg = engine(plan, values).propagate(values)
    expect = brute_force_marginals(factors, sizes, values, factors)
    for got, exp in zip(marg, expect):
        np.testing.assert_allclose(got, exp, rtol=1e-6)


def test_package_exports_the_six_names():
    for name in ("add_factor", "remove_factor", "merge_plans", "merge_trees",
                 "change_root", "insert_sepset"):
        assert getattr(jt, name) is getattr(surgery, name)


# ---------- nested-list surgery ----------

def test_change_root_every_clique_preserves_edges():
    factors, sizes, _ = grid_mrf_model(3, 3, seed=0)
    plan, _ = plans(factors, sizes)
    nested = plan.tree.to_nested()
    ref_edges = edge_set(nested)
    for c in range(plan.tri.num_cliques):
        t2 = surgery.change_root(nested, c)
        assert t2[0] == c
        assert edge_set(t2) == ref_edges
        assert t2 == jax_surgery.change_root(nested, c)


def test_change_root_contracts():
    # already-root: returned unchanged; absent clique: []
    tree = [0, (3, [1]), (4, [2, (5, [6])])]
    assert surgery.change_root(tree, 0) is tree
    assert surgery.change_root(tree, 99) == []


def test_insert_sepset_and_merge_trees():
    t1 = [0, (10, [1])]
    t2 = [2, (11, [3])]
    merged = surgery.merge_trees(t1, 1, t2, 3, 12)
    expect = edge_set(t1) | edge_set(t2) | {(frozenset((1, 3)), 12)}
    assert edge_set(merged) == expect
    assert merged == jax_surgery.merge_trees(t1, 1, t2, 3, 12)
    # the insert itself lands under the requested clique
    got = surgery.insert_sepset(t1, 0, (13, [5]))
    assert (frozenset((0, 5)), 13) in edge_set(got)
    assert got == jax_surgery.insert_sepset(t1, 0, (13, [5]))
    # and the original is untouched (pure)
    assert edge_set(t1) == {(frozenset((0, 1)), 10)}


# ---------- plan-level: add_factor ----------

def test_add_factor_covered_keeps_tree_and_matches_oracle():
    factors, sizes, values = grid_mrf_model(3, 3, seed=1)
    plan, jplan = plans(factors, sizes)
    # a pairwise factor inside an existing clique: any clique's first two vars
    cv = next(c for c in plan.tri.maxcliques if len(c) >= 2)
    scope = [plan.table.label_of(cv[0]), plan.table.label_of(cv[1])]
    plan2, covered = surgery.add_factor(plan, scope)
    assert covered
    # structure is untouched: same tree object, same cliques/separators
    assert plan2.tree is plan.tree
    assert plan2.tri.maxcliques == plan.tri.maxcliques
    assert len(plan2.factors) == len(plan.factors) + 1
    check_running_intersection(plan2)
    assert plan2.to_json() == jax_surgery.add_factor(jplan, scope)[0].to_json()
    rng = np.random.default_rng(7)
    val = rng.random((sizes[scope[0]], sizes[scope[1]])) + 0.1
    check_propagate(plan2, list(factors) + [scope], sizes, list(values) + [val])


def test_add_factor_scalar_scope_covered():
    factors, sizes, _ = chain_bn_model(4)
    plan, jplan = plans(factors, sizes)
    plan2, covered = surgery.add_factor(plan, [])
    assert covered and plan2.tri.factor_to_maxclique[-1] == -1
    assert plan2.to_json() == jax_surgery.add_factor(jplan, [])[0].to_json()


def test_add_factor_uncovered_rebuilds_and_matches_oracle():
    factors, sizes, values = chain_bn_model(5, card=2)
    plan, jplan = plans(factors, sizes)
    ends = [list(sizes)[0], list(sizes)[-1]]  # chain ends: never one clique
    plan2, covered = surgery.add_factor(plan, ends)
    assert not covered
    assert len(plan2.factors) == len(plan.factors) + 1
    check_running_intersection(plan2)
    assert plan2.to_json() == jax_surgery.add_factor(jplan, ends)[0].to_json()
    rng = np.random.default_rng(3)
    val = rng.random((sizes[ends[0]], sizes[ends[1]])) + 0.1
    check_propagate(plan2, list(factors) + [ends], sizes, list(values) + [val])


def test_add_factor_uncovered_refuses_without_rebuild():
    factors, sizes, _ = chain_bn_model(5)
    plan, _ = plans(factors, sizes)
    ends = [list(sizes)[0], list(sizes)[-1]]
    with pytest.raises(ValueError, match="not covered"):
        surgery.add_factor(plan, ends, allow_rebuild=False)
    with pytest.raises(ValueError, match="repeated"):
        surgery.add_factor(plan, [ends[0], ends[0]])


def test_add_factor_new_variable_needs_sizes():
    factors, sizes, _ = chain_bn_model(3)
    plan, jplan = plans(factors, sizes)
    scope = [list(sizes)[0], "brand_new"]
    with pytest.raises(KeyError, match="cardinality"):
        surgery.add_factor(plan, scope)
    plan2, covered = surgery.add_factor(plan, scope, sizes={"brand_new": 3})
    assert not covered
    assert "brand_new" in plan2.table
    assert plan2.to_json() == jax_surgery.add_factor(
        jplan, scope, sizes={"brand_new": 3})[0].to_json()


# ---------- plan-level: remove_factor ----------

def test_remove_factor_matches_oracle():
    factors, sizes, values = grid_mrf_model(2, 3, seed=2)
    plan, jplan = plans(factors, sizes)
    ix = len(factors) // 2
    plan2 = surgery.remove_factor(plan, ix)
    assert len(plan2.factors) == len(factors) - 1
    assert plan2.tree is plan.tree
    check_running_intersection(plan2)
    assert plan2.to_json() == jax_surgery.remove_factor(jplan, ix).to_json()
    keep = [i for i in range(len(factors)) if i != ix]
    check_propagate(plan2, [factors[i] for i in keep], sizes,
                    [values[i] for i in keep])


def test_remove_factor_bounds():
    factors, sizes, _ = chain_bn_model(3)
    plan, _ = plans(factors, sizes)
    with pytest.raises(IndexError):
        surgery.remove_factor(plan, len(factors))
    single = jt.compile_plan([factors[0]], sizes)
    with pytest.raises(ValueError, match="last factor"):
        surgery.remove_factor(single, 0)


# ---------- plan-level: merge_plans ----------

def _disjoint_models():
    f1, s1, v1 = chain_bn_model(4, card=2)
    f2raw, s2raw, v2 = grid_mrf_model(2, 2, seed=5)
    # prefix-relabel the grid so variable sets are disjoint
    ren = {k: ("m_" + k) for k in s2raw}
    f2 = [[ren[v] for v in f] for f in f2raw]
    s2 = {ren[k]: s for k, s in s2raw.items()}
    return (f1, s1, v1), (f2, s2, v2)


def test_merge_plans_disjoint_models_exact():
    (f1, s1, v1), (f2, s2, v2) = _disjoint_models()
    p1, j1 = plans(f1, s1)
    p2, j2 = plans(f2, s2)
    merged = surgery.merge_plans(p1, p2)
    check_running_intersection(merged)
    assert merged.tri.num_cliques == p1.tri.num_cliques + p2.tri.num_cliques
    # exactly one new (empty) separator joins the components
    assert len(merged.tree.separators) == (
        len(p1.tree.separators) + len(p2.tree.separators) + 1
    )
    assert merged.tree.separators[-1] == []
    assert merged.to_json() == jax_surgery.merge_plans(j1, j2).to_json()
    all_values = list(v1) + list(v2)
    check_propagate(merged, f1 + f2, dict(s1, **s2), all_values)
    # logZ of the forest = sum of the component logZs
    _, logz = engine(merged, all_values).posterior_batch(
        jt.batch_masks(merged, [{}]))
    z1 = brute_force_marginals(f1, s1, v1, [f1[0]])[0].sum()
    z2 = brute_force_marginals(f2, s2, v2, [f2[0]])[0].sum()
    np.testing.assert_allclose(float(logz[0]), np.log(z1) + np.log(z2), rtol=1e-9)


def test_merge_plans_shared_vars_refused():
    f1, s1, _ = chain_bn_model(3)
    p1, _ = plans(f1, s1)
    with pytest.raises(ValueError, match="disjoint"):
        surgery.merge_plans(p1, p1)


def test_merge_plans_shared_vars_rebuild():
    """Overlapping models merge via recompilation: the union model's
    marginals match the brute-force oracle over the concatenated factors."""
    f1 = [["a", "b"], ["b", "c"]]
    s1 = {"a": 2, "b": 3, "c": 2}
    f2 = [["b", "d"], ["d", "e"]]
    s2 = {"b": 3, "d": 2, "e": 2}
    p1, j1 = plans(f1, s1)
    p2, j2 = plans(f2, s2)
    merged = surgery.merge_plans(p1, p2, on_shared="rebuild")
    check_running_intersection(merged)
    assert merged.to_json() == jax_surgery.merge_plans(
        j1, j2, on_shared="rebuild").to_json()
    rng = np.random.default_rng(13)
    v1 = [rng.random(tuple(s1[v] for v in f)) + 0.1 for f in f1]
    v2 = [rng.random(tuple(s2[v] for v in f)) + 0.1 for f in f2]
    check_propagate(merged, f1 + f2, dict(s1, **s2), v1 + v2)
    # cardinality conflict on a shared label is refused
    p3 = jt.compile_plan([["b", "z"]], {"b": 4, "z": 2})
    with pytest.raises(ValueError, match="cardinality"):
        surgery.merge_plans(p1, p3, on_shared="rebuild")


# ---------- JunctionTree-level API ----------

def test_junction_tree_surgery_api():
    factors, sizes, values = grid_mrf_model(2, 2, seed=9)
    tree = jt.create_junction_tree(factors, sizes)
    jtree = jt_jax.create_junction_tree(factors, sizes)
    f2raw, s2raw, v2 = chain_bn_model(3)
    ren = {k: ("x_" + str(k)) for k in s2raw}
    f2 = [[ren[v] for v in f] for f in f2raw]
    s2 = {ren[k]: s for k, s in s2raw.items()}
    merged = tree.merge(jt.create_junction_tree(f2, s2))
    assert len(merged.maxcliques) == len(tree.maxcliques) + 2
    assert merged.plan.to_json() == jtree.merge(
        jt_jax.create_junction_tree(f2, s2)).plan.to_json()
    marg = merged.propagate(list(values) + list(v2), device="cpu")
    assert len(marg) == len(values) + len(v2)
    base = tree.propagate(values, device="cpu")
    grown = tree.add_factor(list(factors[0]))
    assert grown.plan.to_json() == jtree.add_factor(list(factors[0])).plan.to_json()
    marg2 = grown.propagate(list(values) + [np.ones_like(values[0])], device="cpu")
    for got, exp in zip(marg2[: len(values)], base):
        np.testing.assert_allclose(got, exp, rtol=1e-9)
    shrunk = grown.remove_factor(len(values))
    for got, exp in zip(shrunk.propagate(values, device="cpu"), base):
        np.testing.assert_allclose(got, exp, rtol=1e-9)


# ---------- Engine.multiply_factor (live serving-side update) ----------

def test_engine_multiply_factor_matches_rebuilt_engine_and_jax():
    """Baking a covered factor into a live engine's potentials must answer
    queries identically to a from-scratch engine on the grown model and to
    the JAX engine after the same edit, without dropping a cached
    program."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=8)
    plan, jplan = plans(factors, sizes)
    cv = next(c for c in plan.tri.maxcliques if len(c) >= 2)
    scope = [plan.table.label_of(cv[1]), plan.table.label_of(cv[0])]  # unsorted
    rng = np.random.default_rng(21)
    val = rng.random((sizes[scope[0]], sizes[scope[1]])) + 0.1
    eng = engine(plan, values)
    masks = jt.batch_masks_sparse(
        plan, jt.random_evidence_batch(plan, 4, list(sizes)[:2], seed=3))
    eng.posterior_batch(masks)
    n_progs = len(eng._programs)
    assert eng.multiply_factor(scope, val) is eng
    post, logz = eng.posterior_batch(masks)
    assert len(eng._programs) == n_progs  # the program is reused
    plan2, covered = surgery.add_factor(plan, scope)
    assert covered
    post2, logz2 = engine(plan2, list(values) + [val]).posterior_batch(masks)
    np.testing.assert_allclose(logz.numpy(), logz2.numpy(), rtol=1e-9)
    for a, b in zip(post, post2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-12)
    jeng = jt_jax.Engine(jplan).set_potentials(values)
    jeng.multiply_factor(scope, val)
    for p, q in zip(eng._pots_np, jeng._pots_np):
        np.testing.assert_allclose(p, q, rtol=1e-12)
    jpost, jlogz = jeng.posterior_batch(masks, mode="general")
    np.testing.assert_allclose(logz.numpy(), np.asarray(jlogz), rtol=1e-9)
    for a, b in zip(post, jpost):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)


def test_multiply_factor_drops_everything_derived_from_the_potentials():
    """The chain stack, the fused stacks, the max-product sibling and the
    bfloat16 program potentials are rebuilt from the new numbers."""
    factors, sizes, values = chain_bn_model(12, card=3, seed=1)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.bfloat16).set_potentials(values)
    masks = jt.batch_masks_sparse(
        tree.plan, jt.random_evidence_batch(tree.plan, 3, ["x2", "x9"], seed=0))
    eng.posterior_batch(masks)                   # chain stack
    eng.posterior_batch(masks, mode="fused")     # fused stacks
    eng.posterior_batch(masks, mode="general")   # bf16 program potentials
    eng.map_assignment({"x2": 1})                # max-product sibling
    assert None not in (eng._chain_A, eng._fused_stack, eng._max_engine,
                        eng._pots_prog)
    val = np.array([[3.0, 0.2, 1.0], [0.5, 2.0, 1.0], [1.0, 1.0, 0.1]])
    eng.multiply_factor(["x4", "x5"], val)
    assert (eng._chain_A, eng._fused_stack, eng._max_engine,
            eng._pots_prog) == (None, None, None, None)
    fresh = jt.create_junction_tree(
        factors + [["x4", "x5"]], sizes
    ).engine(device="cpu", dtype=torch.float64).set_potentials(values + [val])
    want, want_logz = fresh.posterior_batch(masks, mode="general")
    for mode in ("auto", "fused"):
        post, logz = eng.posterior_batch(masks, mode=mode)
        np.testing.assert_allclose(logz.double().numpy(), want_logz.numpy(), rtol=1e-5)
        for v in range(tree.plan.num_vars):
            np.testing.assert_allclose(post[v].double().numpy(), want[v].numpy(),
                                       rtol=1e-4, atol=1e-6)
    got, score = eng.map_assignment({"x2": 1})
    wgot, wscore = fresh.map_assignment({"x2": 1})
    assert got == wgot and score == pytest.approx(wscore, rel=1e-5)


def test_engine_multiply_factor_log_engine_and_errors():
    factors, sizes, values = grid_mrf_model(2, 2, seed=0)
    plan, _ = plans(factors, sizes)
    eng = engine(plan, values, jt.LOG_SUM_EXP)
    cv = plan.tri.maxcliques[0]
    scope = [plan.table.label_of(cv[0])]
    val = np.array([2.0, 0.5])
    eng.multiply_factor(scope, val)
    post, _ = eng.query({})
    expect = brute_force_marginals(
        list(factors) + [scope], sizes, list(values) + [val],
        [[plan.table.label_of(v)] for v in range(plan.num_vars)],
    )
    for v in range(plan.num_vars):
        np.testing.assert_allclose(post[v], expect[v] / expect[v].sum(), rtol=1e-9)
    fg, sg, vg = grid_mrf_model(3, 3, seed=1)
    pg = jt.compile_plan(fg, sg)
    enough = engine(pg, vg)
    a, b = next(
        (a, b)
        for a, b in itertools.combinations(range(pg.num_vars), 2)
        if not any({a, b} <= set(c) for c in pg.tri.maxcliques)
    )
    with pytest.raises(ValueError, match="not covered"):
        enough.multiply_factor(
            [pg.table.label_of(a), pg.table.label_of(b)], np.ones((2, 2))
        )
    with pytest.raises(ValueError, match="unknown"):
        eng.multiply_factor(["nope"], val)
    with pytest.raises(ValueError, match="shape"):
        eng.multiply_factor(scope, np.ones(3))
    with pytest.raises(RuntimeError, match="set_potentials"):
        jt.Engine(plan, device="cpu").multiply_factor(scope, val)
