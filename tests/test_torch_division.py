"""Distribute-pass division trick of the port: against leave-one-out, against
the JAX package with its own division on, on structural zeros, and the
guarded divide against ``grouped_divide_project``."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.config import DEFAULT as JAX_DEFAULT
from junctiontree_tpu.ops.grouped import grouped_divide_project
from junctiontree_tpu.ops.semirings import SEMIRINGS as JAX_SEMIRINGS
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.executor import BatchedProgramBuilder, divide_project
from junctiontree_tpu_torch.models import grid_mrf_model


def _posteriors(tree, values, masks, semiring, division, monkeypatch):
    monkeypatch.setattr(DEFAULT, "distribute_division", division)
    eng = jt.Engine(tree.plan, jt.SEMIRINGS[semiring], device="cpu",
                    dtype=torch.float64).set_potentials(values)
    post, logz = eng.posterior_batch(masks, mode="general")
    return [p.numpy() for p in post], logz.numpy()


def _jax_posteriors(factors, sizes, values, masks, semiring, monkeypatch):
    monkeypatch.setattr(JAX_DEFAULT, "distribute_division", True)
    tree = jt_jax.create_junction_tree(factors, sizes)
    eng = jt_jax.Engine(tree.plan, JAX_SEMIRINGS[semiring]).set_potentials(values)
    post, logz = eng.posterior_batch(masks, mode="general")
    return [np.asarray(p) for p in post], np.asarray(logz)


@pytest.mark.parametrize("semiring", ["sum_product", "log_sum_exp"])
def test_division_matches_leave_one_out_and_jax(semiring, monkeypatch):
    """float64: division against leave-one-out rtol 1e-9, and against the
    JAX package's division program rtol 1e-8."""
    factors, sizes, values = grid_mrf_model(4, 4, seed=3)
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, 6, list(sizes)[:5], seed=4)
    masks = jt.batch_masks_sparse(tree.plan, evs, jt.SEMIRINGS[semiring])
    p1, z1 = _posteriors(tree, values, masks, semiring, True, monkeypatch)
    p0, z0 = _posteriors(tree, values, masks, semiring, False, monkeypatch)
    pj, zj = _jax_posteriors(factors, sizes, values, masks, semiring, monkeypatch)
    np.testing.assert_allclose(z1, z0, rtol=1e-9)
    np.testing.assert_allclose(z1, zj, rtol=1e-8)
    for a, b, c in zip(p1, p0, pj):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a, c, rtol=1e-8, atol=1e-12)


def test_division_takes_the_divide_path(monkeypatch):
    """The flag is read when the program is built: with it on the program
    divides on small sum-product and log-sum-exp cliques, never on
    max-product; with it off nowhere."""
    factors, sizes, _ = grid_mrf_model(3, 3, seed=0)
    plan = jt.compile_plan(factors, sizes)
    parents = [p for p in plan.tree.topo_order if plan.tree.children[p]]
    monkeypatch.setattr(DEFAULT, "distribute_division", True)
    for sr, want in ((jt.SUM_PRODUCT, True), (jt.LOG_SUM_EXP, True),
                     (jt.MAX_PRODUCT, False)):
        b = BatchedProgramBuilder(plan, sr, [0])
        assert all(b._divide_path(p) == want for p in parents)
    b = BatchedProgramBuilder(plan, jt.SUM_PRODUCT, [0])
    b.BELIEF_STATES_CAP = 1   # big cliques keep leave-one-out
    assert not any(b._divide_path(p) for p in parents)
    monkeypatch.setattr(DEFAULT, "distribute_division", False)
    b = BatchedProgramBuilder(plan, jt.SUM_PRODUCT, [0])
    assert not any(b._divide_path(p) for p in parents)


def test_division_with_structural_zeros(monkeypatch):
    """Deterministic CPD entries (exact zeros) exercise the guard: where the
    divisor message is zero the quotient is zero, which is harmless because
    the child's belief is zero there too."""
    factors = [["a"], ["a", "b"], ["b", "c"], ["c", "d"], ["b", "d"]]
    sizes = {"a": 2, "b": 2, "c": 3, "d": 2}
    rng = np.random.default_rng(9)
    values = [rng.random(tuple(sizes[v] for v in f)) + 0.1 for f in factors]
    values[1][0, 1] = 0.0  # deterministic row
    values[2][1, :] = 0.0  # whole slice zero -> zero messages downstream
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, 4, ["a"], seed=5)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    p1, z1 = _posteriors(tree, values, masks, "sum_product", True, monkeypatch)
    p0, z0 = _posteriors(tree, values, masks, "sum_product", False, monkeypatch)
    pj, zj = _jax_posteriors(factors, sizes, values, masks, "sum_product",
                             monkeypatch)
    np.testing.assert_allclose(z1, z0, rtol=1e-9)
    np.testing.assert_allclose(z1, zj, rtol=1e-8)
    for a, b, c in zip(p1, p0, pj):
        assert not np.isnan(a).any()
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a, c, rtol=1e-8, atol=1e-12)


def test_division_impossible_evidence_row(monkeypatch):
    """An impossible row under the division program keeps the contract:
    zero posteriors and logZ = -inf, in both semirings."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=2)
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, 3, ["g0_0", "g2_2"], seed=1)
    for semiring in ("sum_product", "log_sum_exp"):
        sr = jt.SEMIRINGS[semiring]
        masks = jt.batch_masks_sparse(tree.plan, evs, sr)
        masks["g0_0"][1] = sr.zero
        post, logz = _posteriors(tree, values, masks, semiring, True, monkeypatch)
        assert np.isneginf(logz[1]) and np.isfinite(logz[[0, 2]]).all()
        for p in post:
            assert not np.isnan(p).any() and (p[1] == 0).all()


@pytest.mark.parametrize("case", ["batched", "unbatched_divisor", "log",
                                  "unbatched_belief", "two_var_separator"])
def test_divide_project_matches_grouped_divide_project(case):
    """The guarded divide against the JAX package's, float64, rtol 1e-12."""
    rng = np.random.default_rng(2)
    sizes = [2, 3, 4]
    B = 5
    bel = rng.random((B, 2, 3, 4))
    msg = rng.random((B, 3))
    msg[0, 1] = 0.0
    belv, msgv, name = [-1, 0, 1, 2], [-1, 1], "sum_product"
    if case == "unbatched_divisor":
        msg, msgv = rng.random((3,)), [1]
    elif case == "log":
        bel = np.log(bel)
        msg = np.where(msg > 0, np.log(np.maximum(msg, 1e-300)), -np.inf)
        name = "log_sum_exp"
    elif case == "unbatched_belief":
        bel, belv, msg, msgv = bel[0], [0, 1, 2], msg[0], [1]
    elif case == "two_var_separator":
        msg, msgv = rng.random((B, 2, 4)), [-1, 0, 2]
        msg[1, 0, 3] = 0.0
    want = np.asarray(grouped_divide_project(
        JAX_SEMIRINGS[name], bel, belv, msg, msgv, sizes, -1))
    got = divide_project(
        jt.SEMIRINGS[name], torch.as_tensor(bel), belv, torch.as_tensor(msg), msgv
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)
    if case == "batched":
        assert got[0, 1] == 0.0
    with pytest.raises(ValueError, match="unbatched belief"):
        divide_project(jt.SUM_PRODUCT, torch.ones(3), [1], torch.ones(2, 3), [-1, 1])
