"""``junctiontree_tpu_torch.approx`` case for case with
``tests/test_approx.py``.  Both packages run loopy BP in float32; at a fixed
iteration count (``tol=0``) the port's beliefs and Bethe logZ are held to the
JAX package's on the same arrays (atol 2e-5: float32 products and sums in
another order, carried through the iterations), and to the brute force where
BP is exact."""

import numpy as np
import pytest
import torch

import junctiontree_tpu_torch as jt
from junctiontree_tpu import approx as japprox
from junctiontree_tpu_torch import LoopyEngine
from junctiontree_tpu_torch.models import grid_mrf_model

from .test_map import exhaustive_map
from .util import brute_force_marginals, chain_bn, grid_mrf, random_values


def _exact(factors, sizes, values, evidence=None):
    var_list = list(sizes)
    expect = brute_force_marginals(
        factors, sizes, values, [[v] for v in var_list], evidence=evidence)
    z = brute_force_marginals(factors, sizes, values, [[]], evidence=evidence)[0]
    return {v: e / e.sum() for v, e in zip(var_list, expect)}, float(np.log(z))


def _beside_jax(factors, sizes, values, masks, B, mode="sum", **settings):
    """Both engines for a fixed number of iterations on the same arrays."""
    settings = dict(settings, tol=0.0)
    jeng = japprox.LoopyEngine(factors, sizes, values, **settings)
    eng = jt.loopy_engine_from_numpy(factors, sizes, values, device="cpu", **settings)
    if mode == "max":
        a, s, info = eng.map_assignment_batch(masks, batch=B)
        ja, js, jinfo = jeng.map_assignment_batch(masks, batch=B)
        assert info["iters"] == jinfo["iters"]
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_allclose(s, js, rtol=1e-5)
        return
    margs, logz, info = eng.posterior_batch(masks, batch=B)
    jmargs, jlogz, jinfo = jeng.posterior_batch(masks, batch=B)
    assert info["iters"] == jinfo["iters"] == settings.get("max_iters", 200)
    np.testing.assert_allclose(logz.numpy(), np.asarray(jlogz), atol=2e-5, rtol=2e-5)
    assert len(margs) == len(jmargs) == eng.num_vars
    for m, jm in zip(margs, jmargs):
        assert tuple(m.shape) == tuple(jm.shape)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=2e-5)


def test_loopy_exact_on_tree():
    factors, sizes = chain_bn(6)
    values = random_values(factors, sizes, seed=3)
    eng = LoopyEngine(factors, sizes, values, damping=0.0, tol=1e-12, device="cpu")
    margs, logz, info = eng.posterior(None)
    want, want_logz = _exact(factors, sizes, values)
    for v in sizes:
        np.testing.assert_allclose(margs[eng.table.id_of(v)], want[v], atol=1e-6)
    np.testing.assert_allclose(logz, want_logz, atol=1e-5)
    _beside_jax(factors, sizes, values, {}, 1, damping=0.0, max_iters=50)


def test_loopy_exact_on_tree_with_evidence():
    factors, sizes = chain_bn(5)
    values = random_values(factors, sizes, seed=9)
    eng = LoopyEngine(factors, sizes, values, damping=0.0, tol=1e-12, device="cpu")
    ev = {"x1": 1, "x3": 0}
    margs, logz, info = eng.posterior(ev)
    want, want_logz = _exact(factors, sizes, values, ev)
    for v in sizes:
        np.testing.assert_allclose(margs[eng.table.id_of(v)], want[v], atol=1e-6)
    np.testing.assert_allclose(logz, want_logz, atol=1e-5)


def test_loopy_close_on_small_loopy_graph():
    factors, sizes = grid_mrf(3, 3)
    rng = np.random.default_rng(4)
    values = [np.exp(0.3 * rng.standard_normal(tuple(sizes[v] for v in f)))
              for f in factors]
    eng = LoopyEngine(factors, sizes, values, damping=0.5, max_iters=500,
                      tol=1e-10, device="cpu")
    margs, logz, info = eng.posterior(None)
    assert info["delta"] < 1e-8, "did not converge"
    want, want_logz = _exact(factors, sizes, values)
    for v in sizes:
        np.testing.assert_allclose(margs[eng.table.id_of(v)], want[v], atol=0.03)
    np.testing.assert_allclose(logz, want_logz, rtol=0.01)
    _beside_jax(factors, sizes, values, {}, 1, damping=0.5, max_iters=100)


def test_loopy_batched_matches_single_and_jax():
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=7)
    eng = LoopyEngine(factors, sizes, values, damping=0.3, tol=1e-11, device="cpu")
    B = 3
    m00 = np.zeros((B, 2), dtype=np.float32)
    m00[[0, 1, 2], [0, 1, 0]] = 1.0
    margs, logz, _ = eng.posterior_batch({"g0_0": m00})
    for b, s in enumerate([0, 1, 0]):
        single, lz, _ = eng.posterior({"g0_0": s})
        for v in range(eng.num_vars):
            np.testing.assert_allclose(margs[v].numpy()[b], single[v], atol=1e-5)
        np.testing.assert_allclose(float(logz[b]), lz, atol=1e-5)
    _beside_jax(factors, sizes, values, {"g0_0": m00}, B, damping=0.3,
                max_iters=100, chunk_iters=25)


def test_loopy_mixed_cardinalities_match_jax():
    """Factors of several shapes (three buckets, padded lanes) and a unary
    factor, with soft evidence."""
    factors = [["a", "b"], ["b", "c"], ["c", "a"], ["c"], ["a", "b", "d"]]
    sizes = {"a": 2, "b": 3, "c": 4, "d": 2}
    values = random_values(factors, sizes, seed=5)
    masks = {"c": np.random.default_rng(0).random((4, 4)).astype(np.float32) + 0.1,
             "d": np.tile(np.array([[0.0, 1.0]], dtype=np.float32), (4, 1))}
    _beside_jax(factors, sizes, values, masks, 4, damping=0.4, max_iters=60,
                chunk_iters=20)


def test_loopy_large_grid_runs():
    factors, sizes, values = grid_mrf_model(12, 12, coupling=0.25, seed=1)
    eng = LoopyEngine(factors, sizes, values, damping=0.5, max_iters=300,
                      device="cpu")
    margs, logz, info = eng.posterior(None)
    assert np.isfinite(float(logz))
    tree = jt.create_junction_tree(factors, sizes)
    post, _z = tree.engine(device="cpu", dtype=torch.float64).set_potentials(
        values).query({})
    for v in ["g0_0", "g5_5", "g11_11"]:
        np.testing.assert_allclose(
            margs[eng.table.id_of(v)], post[tree.plan.table.id_of(v)], atol=0.03)
    _beside_jax(factors, sizes, values, {}, 1, damping=0.5, max_iters=50)


def test_loopy_map_exact_on_tree():
    factors, sizes = chain_bn(5)
    values = random_values(factors, sizes, seed=13)
    eng = LoopyEngine(factors, sizes, values, damping=0.0, tol=1e-12, device="cpu")
    got, score, info = eng.map_assignment({"x2": 1})
    want, want_score = exhaustive_map(factors, sizes, values, evidence={"x2": 1})
    assert got == want
    np.testing.assert_allclose(score, want_score, rtol=1e-5)


def test_loopy_map_batch_and_infeasible():
    factors, sizes = grid_mrf(2, 2)
    values = random_values(factors, sizes, seed=17)
    eng = LoopyEngine(factors, sizes, values, damping=0.3, tol=1e-11, device="cpu")
    m = np.zeros((2, 2), dtype=np.float32)
    m[0, 1] = 1.0  # row 1 stays infeasible: all states forbidden
    assign, scores, info = eng.map_assignment_batch({"g0_0": m})
    assert assign.dtype == np.int32 and assign.shape == (2, 4)
    want, want_score = exhaustive_map(factors, sizes, values, evidence={"g0_0": 1})
    np.testing.assert_allclose(scores[0], want_score, rtol=1e-4)
    assert scores[1] == -np.inf
    _beside_jax(factors, sizes, values, {"g0_0": m[:1]}, 1, mode="max",
                damping=0.3, max_iters=100)


def test_loopy_tol_zero_reads_delta_once():
    """With ``tol <= 0`` the loop runs to ``max_iters`` and reads the delta
    once, after the last chunk; with a tolerance it stops at the first chunk
    under it."""
    factors, sizes = chain_bn(4)
    values = random_values(factors, sizes, seed=2)
    eng = LoopyEngine(factors, sizes, values, damping=0.0, tol=0.0,
                      max_iters=40, chunk_iters=10, device="cpu")
    _, _, info = eng.posterior(None)
    assert info["iters"] == 40 and info["delta"] < 1e-6
    eng2 = LoopyEngine(factors, sizes, values, damping=0.0, tol=1e-6,
                       max_iters=40, chunk_iters=10, device="cpu")
    _, _, info2 = eng2.posterior(None)
    assert info2["iters"] == 10


def test_loopy_errors():
    factors, sizes = chain_bn(3)
    values = random_values(factors, sizes, seed=1)
    eng = LoopyEngine(factors, sizes, device="cpu")
    with pytest.raises(RuntimeError, match="set_potentials"):
        eng.posterior({})
    with pytest.raises(ValueError, match="shape"):
        eng.set_potentials([np.ones(3)] + values[1:])
    eng.set_potentials(values)
    with pytest.raises(ValueError, match="out of range"):
        eng.posterior({"x0": 5})
    with pytest.raises(ValueError, match="batch"):
        eng.posterior_batch({})
    with pytest.raises(ValueError, match="expected"):
        eng.posterior_batch({"x0": np.ones((2, 3))})
    with pytest.raises(ValueError, match="factor"):
        LoopyEngine([], {}, device="cpu")


def test_loopy_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    factors, sizes = chain_bn(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        LoopyEngine(factors, sizes)
