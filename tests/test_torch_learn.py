"""``junctiontree_tpu_torch.learn`` against ``junctiontree_tpu.learn`` on the
same seeded data, case for case with ``tests/test_learn.py``.

Both sides run in float64 on the CPU (the JAX side follows ``x64``).
Tolerances: gradients, expected counts and likelihoods rtol 1e-8 (the same
sums in another order); loss histories of 20 Adam steps rtol 1e-6 and the
fitted parameters atol 1e-6 (the two Adam updates are the same arithmetic;
the differences of the gradients grow over the steps); EM histories rtol
1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu import learn as jlearn
from junctiontree_tpu.sampling import engine_sample as jax_engine_sample
from junctiontree_tpu_torch import learn
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS

from .util import chain_bn, grid_mrf, random_values

CPU64 = dict(device="cpu", dtype=torch.float64)


def _plans(factors, sizes):
    plan = jt.compile_plan(factors, sizes)
    jplan = jt_jax.compile_plan(factors, sizes)
    assert plan.to_json() == jplan.to_json()
    return plan, jplan


def _sampled(factors, sizes, values, seed, n):
    """Exact samples of the model, drawn once (by the JAX package) and given
    to both learners."""
    eng = jt_jax.create_junction_tree(factors, sizes).engine().set_potentials(values)
    return np.asarray(jax_engine_sample(eng, jax.random.PRNGKey(seed), n))


def _cpd_chain(n, card=2, seed=0):
    """Chain BN with proper CPD values (child = last axis)."""
    factors, sizes = chain_bn(n, card)
    rng = np.random.default_rng(seed)
    values = []
    for f in factors:
        t = rng.random(tuple(sizes[v] for v in f)) + 0.2
        values.append(t / t.sum(axis=-1, keepdims=True))
    return factors, sizes, values


def _same_fit(got, want, rtol=1e-6, atol=1e-6):
    (thetas, hist), (jthetas, jhist) = got, want
    np.testing.assert_allclose(hist, jhist, rtol=rtol)
    for t, jt_ in zip(thetas, jthetas):
        np.testing.assert_allclose(t, np.asarray(jt_), atol=atol)


def test_empirical_marginals():
    plan, jplan = _plans([["a", "b"], ["b"]], {"a": 2, "b": 3})
    data = np.array([[0, 1], [0, 1], [1, 2], [0, 0]])
    emp = learn.empirical_marginals(plan, data)
    for e, je in zip(emp, jlearn.empirical_marginals(jplan, data)):
        np.testing.assert_array_equal(e, je)
    np.testing.assert_allclose(emp[1], [0.25, 0.5, 0.25])


def test_fit_matches_jax_and_moves_to_the_moments():
    factors, sizes = grid_mrf(2, 2)
    values = random_values(factors, sizes, seed=77)
    plan, jplan = _plans(factors, sizes)
    data = _sampled(factors, sizes, values, 3, 4000)
    got = learn.fit_mle(plan, data, steps=20, learning_rate=0.5, **CPU64)
    _same_fit(got, jlearn.fit_mle(jplan, data, steps=20, learning_rate=0.5))
    # the rest of the way: moment matching at convergence
    thetas, history = learn.fit_mle(
        plan, data, steps=130, learning_rate=0.5, init_thetas=got[0], **CPU64)
    assert history[-1] > got[1][0]
    fitted = learn.model_marginals(plan, thetas, **CPU64)
    for f_m, e_m in zip(fitted, learn.empirical_marginals(plan, data)):
        np.testing.assert_allclose(f_m, e_m, atol=0.02)


def test_fit_warm_start_leaves_the_callers_arrays():
    factors, sizes = grid_mrf(2, 2)
    plan, jplan = _plans(factors, sizes)
    data = np.random.default_rng(0).integers(0, 2, size=(50, 4))
    init = [np.full(tuple(plan.sizes[v] for v in f), 0.1) for f in plan.factors]
    kept = [t.copy() for t in init]
    got = learn.fit_mle(plan, data, steps=5, init_thetas=init, **CPU64)
    for a, b in zip(init, kept):
        np.testing.assert_array_equal(a, b)
    _same_fit(got, jlearn.fit_mle(jplan, data, steps=5, init_thetas=init))


def test_loglik_of_truth_beats_uniform():
    factors, sizes = chain_bn(4)
    values = random_values(factors, sizes, seed=5)
    plan, jplan = _plans(factors, sizes)
    data = _sampled(factors, sizes, values, 1, 2000)
    emp = learn.empirical_marginals(plan, data)
    truth = [np.log(np.asarray(v)) for v in values]
    unif = [np.zeros(tuple(sizes[x] for x in f)) for f in factors]
    ll_truth = float(learn.log_likelihood(plan, truth, emp, **CPU64))
    ll_unif = float(learn.log_likelihood(plan, unif, emp, **CPU64))
    assert ll_truth > ll_unif
    for th, ll in ((truth, ll_truth), (unif, ll_unif)):
        want = jlearn.log_likelihood(
            jplan, [jnp.asarray(t) for t in th], [jnp.asarray(m) for m in emp])
        np.testing.assert_allclose(ll, float(want), rtol=1e-8)


def test_gradient_of_loglik_matches_jax():
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=2)
    plan, jplan = _plans(factors, sizes)
    data = np.random.default_rng(4).integers(0, 2, size=(30, plan.num_vars))
    emp = learn.empirical_marginals(plan, data)
    thetas = [torch.tensor(np.log(v), requires_grad=True) for v in values]
    ll = learn.log_likelihood(plan, thetas, [torch.tensor(m) for m in emp])
    grads = torch.autograd.grad(ll, thetas)
    jgrads = jax.grad(lambda th: jlearn.log_likelihood(
        jplan, th, [jnp.asarray(m) for m in emp]))([jnp.log(jnp.asarray(v)) for v in values])
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8, atol=1e-12)


def test_masks_from_data_and_marginal_loglik():
    factors, sizes, values = _cpd_chain(3, seed=11)
    plan, jplan = _plans(factors, sizes)
    data = np.array([[0, 1, -1], [1, -1, 0]])
    masks = learn.masks_from_data(plan, data)
    for m, jm in zip(masks, jlearn.masks_from_data(jplan, data)):
        np.testing.assert_array_equal(m, jm)
    assert masks[plan.table.id_of("x2")].tolist()[0] == [1.0, 1.0]
    with pytest.raises(ValueError, match="out of range"):
        learn.masks_from_data(plan, np.array([[0, 5, 0]]))
    thetas = [np.log(np.asarray(v)) for v in values]
    got = float(learn.marginal_log_likelihood(plan, thetas, masks, **CPU64))
    joint = np.einsum("a,ab,bc->abc", *values)
    want = np.mean(np.log([joint[0, 1, :].sum(), joint[1, :, 0].sum()]))
    np.testing.assert_allclose(got, want, rtol=1e-8)
    jgot = jlearn.marginal_log_likelihood(
        jplan, [jnp.asarray(t) for t in thetas], [jnp.asarray(m) for m in masks])
    np.testing.assert_allclose(got, float(jgot), rtol=1e-8)


def test_expected_counts_complete_data_are_empirical():
    factors, sizes, values = _cpd_chain(4, seed=3)
    plan, jplan = _plans(factors, sizes)
    data = np.random.default_rng(0).integers(0, 2, size=(50, plan.num_vars))
    masks = learn.masks_from_data(plan, data)
    counts = learn.expected_counts(plan, values, masks, **CPU64)
    for c, e in zip(counts, learn.empirical_marginals(plan, data)):
        np.testing.assert_allclose(c, 50 * e, atol=1e-9)
    jcounts = jlearn.expected_counts(jplan, values, [jnp.asarray(m) for m in masks])
    for c, jc in zip(counts, jcounts):
        np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("model", ["grid", "chain3"])
def test_expected_counts_missing_data_match_jax(model):
    if model == "grid":
        factors, sizes = grid_mrf(3, 3)
        values = random_values(factors, sizes, seed=8)
    else:
        factors, sizes, values = _cpd_chain(6, card=3, seed=4)
    plan, jplan = _plans(factors, sizes)
    rng = np.random.default_rng(6)
    data = np.stack([rng.integers(0, plan.sizes[v], 40)
                     for v in range(plan.num_vars)], axis=1)
    data[rng.random(data.shape) < 0.35] = -1
    masks = learn.masks_from_data(plan, data)
    calls = TIMERS.counters()["big_clique_sep_message.calls"]
    counts = learn.expected_counts(plan, values, masks, **CPU64)
    # small cliques: einsum
    assert TIMERS.counters()["big_clique_sep_message.calls"] == calls
    jcounts = jlearn.expected_counts(jplan, values, [jnp.asarray(m) for m in masks])
    for c, jc in zip(counts, jcounts):
        np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(c.sum(), 40.0, rtol=1e-8)


def test_fit_em_complete_data_is_counting():
    factors, sizes, values = _cpd_chain(3, seed=7)
    plan, jplan = _plans(factors, sizes)
    data = _sampled(factors, sizes, values, 0, 500)
    learned, hist = learn.fit_em(plan, data, steps=3, smoothing=0.0, **CPU64)
    for lv, e in zip(learned, learn.empirical_marginals(plan, data)):
        cond = e / np.maximum(e.sum(axis=-1, keepdims=True), 1e-12)
        np.testing.assert_allclose(lv, cond, atol=1e-9)
    np.testing.assert_allclose(hist[1], hist[2], atol=1e-9)
    jlearned, jhist = jlearn.fit_em(jplan, data, steps=3, smoothing=0.0)
    np.testing.assert_allclose(hist, jhist, rtol=1e-8)
    for lv, jv in zip(learned, jlearned):
        np.testing.assert_allclose(lv, jv, atol=1e-9)


def test_fit_em_hidden_variable_monotone():
    factors, sizes, values = _cpd_chain(3, seed=21)
    plan, jplan = _plans(factors, sizes)
    data = _sampled(factors, sizes, values, 5, 800).copy()
    data[:, plan.table.id_of("x1")] = -1  # x1 never observed
    learned, hist = learn.fit_em(plan, data, steps=25, smoothing=1e-6, seed=4,
                                 **CPU64)
    assert hist[-1] > hist[0]
    assert np.all(np.diff(hist) > -1e-7)
    joint_true = np.einsum("a,ab,bc->ac", *values)
    joint_fit = np.einsum("a,ab,bc->ac", *learned)
    np.testing.assert_allclose(joint_fit, joint_true, atol=0.05)
    jlearned, jhist = jlearn.fit_em(jplan, data, steps=25, smoothing=1e-6, seed=4)
    np.testing.assert_allclose(hist, jhist, rtol=1e-8)
    for lv, jv in zip(learned, jlearned):
        np.testing.assert_allclose(lv, jv, atol=1e-6)


def test_fit_em_rejects_misaligned_child_axes():
    plan, _ = _plans(*chain_bn(3))
    with pytest.raises(ValueError, match="child_axes"):
        learn.fit_em(plan, np.zeros((2, 3), dtype=int), child_axes=[0], **CPU64)


def test_fit_mle_missing_improves_and_matches_jax():
    factors, sizes = grid_mrf(2, 2)
    values = random_values(factors, sizes, seed=9)
    plan, jplan = _plans(factors, sizes)
    data = _sampled(factors, sizes, values, 2, 1500)
    miss = np.random.default_rng(1).random(data.shape) < 0.3
    data_missing = np.where(miss, -1, data)
    got = learn.fit_mle_missing(plan, data_missing, steps=20,
                                learning_rate=0.05, **CPU64)
    assert got[1][-1] > got[1][0]
    _same_fit(got, jlearn.fit_mle_missing(jplan, data_missing, steps=20,
                                          learning_rate=0.05))
    thetas, hist = learn.fit_mle_missing(
        plan, data_missing, steps=130, learning_rate=0.05, init_thetas=got[0],
        **CPU64)
    fitted = learn.model_marginals(plan, thetas, **CPU64)
    truth = learn.model_marginals(plan, [np.log(np.asarray(v)) for v in values],
                                  **CPU64)
    for f_m, t_m in zip(fitted, truth):
        np.testing.assert_allclose(f_m, t_m, atol=0.07)
    jtruth = jlearn.model_marginals(jplan, [np.log(np.asarray(v)) for v in values])
    for t_m, j_m in zip(truth, jtruth):
        np.testing.assert_allclose(t_m, j_m, rtol=1e-8)


def test_float32_is_the_default_dtype():
    factors, sizes = grid_mrf(2, 2)
    plan, _ = _plans(factors, sizes)
    data = np.random.default_rng(0).integers(0, 2, size=(20, 4))
    thetas, hist = learn.fit_mle(plan, data, steps=2, device="cpu")
    assert all(t.dtype == np.float32 for t in thetas) and len(hist) == 2


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    factors, sizes = grid_mrf(2, 2)
    plan, _ = _plans(factors, sizes)
    data = np.zeros((2, 4), dtype=int)
    masks = learn.masks_from_data(plan, data)
    vals = random_values(factors, sizes, seed=0)
    for call in (
        lambda: learn.fit_mle(plan, data, steps=1),
        lambda: learn.fit_mle_missing(plan, data, steps=1),
        lambda: learn.fit_em(plan, data, steps=1),
        lambda: learn.expected_counts(plan, vals, masks),
        lambda: learn.model_marginals(plan, vals),
        lambda: learn.log_likelihood(plan, vals, vals),
        lambda: learn.marginal_log_likelihood(plan, vals, masks),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
