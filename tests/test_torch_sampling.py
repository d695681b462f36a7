"""``junctiontree_tpu_torch.sampling`` case for case with
``tests/test_sampling.py``.  The random streams of the two packages differ
(a ``torch.Generator`` against a JAX key), so draws are held to the exact
marginals of the brute force within 5 standard errors of a binomial
proportion (+1e-3), as the JAX package's own tests hold its sampler, and the
two samplers' frequencies to each other within 7 standard errors."""

import jax
import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.sampling import engine_sample as jax_engine_sample
from junctiontree_tpu_torch.sampling import engine_sample, make_sampler, sample

from .util import brute_force_marginals, chain_bn, grid_mrf, random_values


def _engine(factors, sizes, values, semiring="sum_product"):
    tree = jt.create_junction_tree(factors, sizes)
    return tree, tree.engine(semiring, device="cpu").set_potentials(values)


def _check_empirical(plan, samples, factors, sizes, values, evidence=None):
    n = samples.shape[0]
    var_list = list(sizes)
    expect = brute_force_marginals(
        factors, sizes, values, [[v] for v in var_list], evidence=evidence
    )
    for i, v in enumerate(var_list):
        vid = plan.table.id_of(v)
        p = expect[i] / expect[i].sum()
        emp = np.bincount(samples[:, vid], minlength=sizes[v]) / n
        tol = 5 * np.sqrt(np.maximum(p * (1 - p), 1e-4) / n)
        assert np.all(np.abs(emp - p) <= tol + 1e-3), (v, emp, p)


@pytest.mark.parametrize("semiring", ["sum_product", "log_sum_exp"])
def test_samples_match_marginals(semiring):
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=17)
    tree, eng = _engine(factors, sizes, values, semiring)
    samples = engine_sample(eng, 0, 20000)
    assert samples.shape == (20000, 6) and samples.dtype == np.int32
    _check_empirical(tree.plan, samples, factors, sizes, values)


def test_samples_respect_evidence():
    factors, sizes = chain_bn(6)
    values = random_values(factors, sizes, seed=3)
    tree, eng = _engine(factors, sizes, values)
    ev = {"x2": 1, "x5": 0}
    samples = engine_sample(eng, 1, 10000, evidence=ev)
    assert np.all(samples[:, tree.plan.table.id_of("x2")] == 1)
    assert np.all(samples[:, tree.plan.table.id_of("x5")] == 0)
    _check_empirical(tree.plan, samples, factors, sizes, values, evidence=ev)


def test_pairwise_joint_frequencies():
    """A cross-clique pairwise joint, against the brute force and against
    the JAX sampler's frequencies."""
    factors, sizes = chain_bn(5, card=3)
    values = random_values(factors, sizes, seed=8)
    tree, eng = _engine(factors, sizes, values)
    n = 30000
    samples = engine_sample(eng, 2, n)
    jeng = jt_jax.create_junction_tree(factors, sizes).engine().set_potentials(values)
    jsamples = np.asarray(jax_engine_sample(jeng, jax.random.PRNGKey(2), n))
    (expect,) = brute_force_marginals(factors, sizes, values, [["x0", "x4"]])
    p = expect / expect.sum()
    a, b = tree.plan.table.id_of("x0"), tree.plan.table.id_of("x4")

    def freq(s):
        return np.array([[np.mean((s[:, a] == i) & (s[:, b] == j))
                          for j in range(3)] for i in range(3)])

    se = np.sqrt(np.maximum(p * (1 - p), 1e-4) / n)
    assert np.all(np.abs(freq(samples) - p) <= 5 * se + 1e-3)
    assert np.all(np.abs(freq(samples) - freq(jsamples)) <= 7 * se + 1e-3)


def test_deterministic_given_key():
    factors, sizes = chain_bn(4)
    values = random_values(factors, sizes, seed=1)
    _, eng = _engine(factors, sizes, values)
    s1 = engine_sample(eng, 7, 64)
    s2 = engine_sample(eng, 7, 64)
    np.testing.assert_array_equal(s1, s2)
    assert not np.array_equal(s1, engine_sample(eng, 8, 64))
    # an explicit generator is consumed: two draws from one differ
    gen = torch.Generator(device="cpu").manual_seed(7)
    g1 = engine_sample(eng, gen, 64)
    np.testing.assert_array_equal(g1, s1)
    assert not np.array_equal(engine_sample(eng, gen, 64), g1)


def test_sample_from_beliefs_and_deterministic_factor():
    """``sample`` on propagated beliefs; a deterministic factor (zeros in
    the belief) is never violated."""
    from junctiontree_tpu_torch.executor import evaluate_cliques, propagate_cliques

    factors = [["a"], ["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 2, "c": 3}
    values = [np.array([0.3, 0.7]), np.eye(2), np.array([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]])]
    plan = jt.compile_plan(factors, sizes)
    pots = evaluate_cliques(plan, [torch.tensor(v) for v in values])
    beliefs, _ = propagate_cliques(plan, pots)
    out = sample(plan, beliefs, 3, 5000)
    assert out.dtype == torch.int32 and tuple(out.shape) == (5000, 3)
    s = out.numpy()
    ia, ib = plan.table.id_of("a"), plan.table.id_of("b")
    assert np.all(s[:, ia] == s[:, ib])
    assert abs(np.mean(s[:, ia]) - 0.7) < 5 * np.sqrt(0.21 / 5000)
    fn = make_sampler(plan)
    again = fn(beliefs, torch.Generator().manual_seed(3), 5000)
    assert torch.equal(again, out)
    with pytest.raises(ValueError, match="generator"):
        sample(plan, [b.to("meta") for b in beliefs], torch.Generator(), 4)
