"""``junctiontree_tpu_torch.learn_chain`` against the JAX package's chain
learner and the port's general learner, mirroring the chain cases of
``tests/test_learn.py``.

The JAX chain learner packs its parameters in float32 whatever ``x64`` says,
so the port runs in float32 beside it: loss histories of 20 Adam steps agree
to rtol 2e-4 and parameters to atol 2e-3 (float32 sums in another order,
carried through 20 updates).  Against the port's own general learner in
float64 the first steps agree to rtol 1e-9: the two objectives are the same
function."""

import jax
import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.learn_chain import fit_mle_chain as jax_fit_mle_chain
from junctiontree_tpu.sampling import engine_sample as jax_engine_sample
from junctiontree_tpu_torch import learn
from junctiontree_tpu_torch.learn_chain import (
    _ChainParams,
    chain_masks_from_data,
    fit_mle_chain,
)
from junctiontree_tpu_torch.models import chain_bn_model
from junctiontree_tpu_torch.scan_executor import (
    ChainLayout,
    chain_logz_program,
    chain_posterior_program,
)

from .util import chain_bn, grid_mrf


def _cpd_chain(n, card=2, seed=0):
    factors, sizes = chain_bn(n, card)
    rng = np.random.default_rng(seed)
    values = []
    for f in factors:
        t = rng.random(tuple(sizes[v] for v in f)) + 0.2
        values.append(t / t.sum(axis=-1, keepdims=True))
    return factors, sizes, values


def _missing_chain_data(n=5, seed=31, rows=600):
    factors, sizes, values = _cpd_chain(n, seed=seed)
    eng = jt_jax.create_junction_tree(factors, sizes).engine().set_potentials(values)
    data = np.array(jax_engine_sample(eng, jax.random.PRNGKey(9), rows))
    rng = np.random.default_rng(2)
    return factors, sizes, np.where(rng.random(data.shape) < 0.25, -1, data)


def test_fit_mle_chain_matches_jax():
    factors, sizes, data = _missing_chain_data()
    plan = jt.compile_plan(factors, sizes)
    jplan = jt_jax.compile_plan(factors, sizes)
    th, hist = fit_mle_chain(plan, data, steps=20, learning_rate=0.1, device="cpu")
    jth, jhist = jax_fit_mle_chain(jplan, data, steps=20, learning_rate=0.1)
    np.testing.assert_allclose(hist, jhist, rtol=2e-4)
    for a, b in zip(th, jth):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_fit_mle_chain_matches_general():
    """Chain-specialized learner = general missing-data learner (same
    objective), step for step in float64, and at the optimum."""
    factors, sizes, data = _missing_chain_data()
    plan = jt.compile_plan(factors, sizes)
    kw = dict(device="cpu", dtype=torch.float64)
    th_a, hist_a = fit_mle_chain(plan, data, steps=120, learning_rate=0.1, **kw)
    th_b, hist_b = learn.fit_mle_missing(plan, data, steps=120,
                                         learning_rate=0.1, **kw)
    np.testing.assert_allclose(hist_a[:3], hist_b[:3], rtol=1e-9)
    np.testing.assert_allclose(hist_a[-1], hist_b[-1], atol=5e-3)
    assert hist_a[-1] > hist_a[0]
    ma = learn.model_marginals(plan, th_a, **kw)
    mb = learn.model_marginals(plan, th_b, **kw)
    for a, b in zip(ma, mb):
        np.testing.assert_allclose(a, b, atol=0.02)


def test_fit_mle_chain_long():
    """A 1,000-variable chain: 8 steps improve the likelihood, in time."""
    import time

    n = 1000
    factors, sizes, values = chain_bn_model(n, seed=3)
    plan = jt.compile_plan(factors, sizes)
    rng = np.random.default_rng(0)
    N = 64
    data = np.zeros((N, n), dtype=np.int64)
    cpd0 = np.asarray(values[0]) / np.asarray(values[0]).sum()
    col = rng.choice(2, size=N, p=cpd0)
    data[:, plan.table.id_of("x0")] = col
    for i in range(1, n):
        t = np.asarray(values[i])
        t = t / t.sum(axis=-1, keepdims=True)
        col = (rng.random(N) > t[col, 0]).astype(np.int64)
        data[:, plan.table.id_of(f"x{i}")] = col
    t0 = time.time()
    thetas, hist = fit_mle_chain(plan, data, steps=8, learning_rate=0.2,
                                 device="cpu")
    assert hist[-1] > hist[0]
    assert len(thetas) == len(factors)
    assert time.time() - t0 < 120


def test_fit_mle_chain_rejects_non_chain():
    factors, sizes = grid_mrf(2, 2)
    plan = jt.compile_plan(factors, sizes)
    with pytest.raises(ValueError, match="chain"):
        fit_mle_chain(plan, np.zeros((1, 4), dtype=int), device="cpu")


def test_fit_mle_chain_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    factors, sizes, _ = _cpd_chain(4)
    plan = jt.compile_plan(factors, sizes)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_mle_chain(plan, np.zeros((1, 4), dtype=int), steps=1)


def test_chain_params_round_trip_and_logA():
    factors, sizes, values = _cpd_chain(6, card=3, seed=5)
    plan = jt.compile_plan(factors, sizes)
    layout = ChainLayout.detect(plan)
    params = _ChainParams(plan, layout)
    thetas = [np.log(v) for v in values]
    packed = params.pack(thetas, "cpu", torch.float64)
    for a, b in zip(params.unpack(packed), thetas):
        np.testing.assert_allclose(a, b)
    carried = jt.chain_params_from_numpy(plan.to_json(), thetas, device="cpu",
                                         dtype=torch.float64)
    for k in packed:
        assert torch.equal(packed[k], carried[k])
    # exp(logA) is the stack of clique potentials
    eng = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    want = jt.chain_stack_from_numpy(plan.to_json(), eng._pots_np)
    np.testing.assert_allclose(
        torch.exp(params.build_logA(packed)).numpy(), want, rtol=1e-12)
    masks = chain_masks_from_data(plan, layout, np.array([[0, -1, 2, 1, -1, 0]]))
    assert masks.shape == (6, 1, 3) and masks[1].tolist() == [[1.0, 1.0, 1.0]]
    with pytest.raises(ValueError, match="out of range"):
        chain_masks_from_data(plan, layout, np.array([[0, 7, 2, 1, 0, 0]]))


def test_chain_program_under_grad_equals_its_no_grad_value():
    """One loop, in place without a gradient and functional with one: the
    same posteriors and logZ bit for bit, and a logZ gradient that sums to
    the expected counts."""
    factors, sizes, values = _cpd_chain(7, card=3, seed=8)
    plan = jt.compile_plan(factors, sizes)
    layout = ChainLayout.detect(plan)
    eng = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    A = torch.tensor(jt.chain_stack_from_numpy(plan.to_json(), eng._pots_np))
    rng = np.random.default_rng(0)
    data = rng.integers(0, 3, size=(5, 7))
    data[rng.random(data.shape) < 0.4] = -1
    M = torch.tensor(chain_masks_from_data(plan, layout, data), dtype=torch.float64)
    prog = chain_posterior_program(plan, layout)
    post0, logz0 = prog(A, M)
    Ag = A.clone().requires_grad_(True)
    post1, logz1 = prog(Ag, M)
    assert post1.requires_grad and torch.equal(post1.detach(), post0)
    assert torch.equal(logz1.detach(), logz0)
    lz = chain_logz_program(plan, layout)(Ag, M)
    assert torch.equal(lz.detach(), logz0)
    (g,) = torch.autograd.grad(lz.sum(), Ag)
    # d logZ / d log A summed over a clique's states = one per data row
    np.testing.assert_allclose((g * A).sum(dim=(1, 2)).numpy(), 5.0, rtol=1e-10)
    with torch.no_grad():
        post2, _ = prog(Ag, M)
    assert torch.equal(post2, post0)
