"""The port's log-space semirings (``LOG_SUM_EXP``, ``MAX_PRODUCT``) against
the JAX package's on the same operands, including the max-shifted
log-matmul-exp branch (threshold lowered so it runs at a small size), and
log-space engines against the JAX engines and the port's linear engine."""

import numpy as np
import pytest
import torch
from scipy.special import logsumexp

import junctiontree_tpu as jt_jax
import junctiontree_tpu.ops.semirings as jax_sr
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.models import grid_mrf_model, sprinkler_model
from junctiontree_tpu_torch.ops import semirings as sr


@pytest.fixture()
def low_threshold(monkeypatch):
    """Both packages take the log-matmul-exp branch at any size."""
    monkeypatch.setattr(sr, "LOG_EINSUM_MIN_STATES", 1)
    monkeypatch.setattr(jax_sr, "LOG_EINSUM_MIN_STATES", 1)


def _rand_log(shape, rng, lo=-8.0, hi=3.0):
    return rng.uniform(lo, hi, size=shape)


def _t(x):
    return torch.as_tensor(x, dtype=torch.float64)


def _random_operands(seed, n_ops):
    rng = np.random.default_rng(seed)
    extent = {v: int(rng.integers(2, 4)) for v in range(6)}
    extent[-1] = 3
    ovs = []
    for _ in range(n_ops):
        k = int(rng.integers(1, 4))
        vs = [int(x) for x in rng.choice(6, size=k, replace=False)]
        if rng.random() < 0.4:
            vs = [-1] + vs
        ovs.append(vs)
    union = sr._union_scope(ovs, [])
    out = [v for v in union if rng.random() < 0.4]
    ops = [_rand_log(tuple(extent[v] for v in vs), rng) for vs in ovs]
    return ops, ovs, out


@pytest.mark.parametrize("name", ["log_sum_exp", "max_product"])
@pytest.mark.parametrize("n_ops", [1, 2, 3, 5])
def test_log_contract_matches_jax(name, n_ops):
    """Broadcast-combine-reduce path, float64, rtol 1e-10."""
    ops, ovs, out = _random_operands(40 + n_ops, n_ops)
    want = np.asarray(jax_sr.SEMIRINGS[name].contract(ops, ovs, out))
    got = sr.SEMIRINGS[name].contract([_t(o) for o in ops], ovs, out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("n_ops", [2, 3, 5])
def test_log_matmul_exp_matches_jax(low_threshold, n_ops):
    """The max-shifted einsum branch of both packages, float64: rtol 1e-9
    (the two plan their pairwise products in different orders)."""
    ops, ovs, out = _random_operands(70 + n_ops, n_ops)
    want = np.asarray(jax_sr.LOG_SUM_EXP.contract(ops, ovs, out))
    got = sr.LOG_SUM_EXP.contract([_t(o) for o in ops], ovs, out).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_log_einsum_matches_reduce(low_threshold):
    rng = np.random.default_rng(0)
    a = _rand_log((4, 5, 6), rng)
    b = _rand_log((7, 5, 3), rng)   # batched message [B, v1, v3]
    got = sr.LOG_SUM_EXP.contract(
        [_t(a), _t(b)], [[0, 1, 2], [-1, 1, 3]], [-1, 2]
    ).numpy()
    big = a[None, :, :, :, None] + b[:, None, :, None, :]  # [B,v0,v1,v2,v3]
    np.testing.assert_allclose(got, logsumexp(big, axis=(1, 2, 4)), rtol=1e-10)


def test_log_einsum_runs_the_shifted_branch(low_threshold, monkeypatch):
    calls = []
    inner = sr._log_matmul_exp
    monkeypatch.setattr(
        sr, "_log_matmul_exp", lambda *a: calls.append(1) or inner(*a)
    )
    x = _t(np.zeros((2, 2)))
    sr.LOG_SUM_EXP.contract([x, x], [[0, 1], [1, 2]], [2])
    assert calls == [1]
    sr.LOG_SUM_EXP.contract([x], [[0, 1]], [1])      # one operand: reduce
    sr.MAX_PRODUCT.contract([x, x], [[0, 1], [1, 2]], [2])
    assert calls == [1]


def test_log_einsum_neg_inf_blocks(low_threshold):
    rng = np.random.default_rng(1)
    a = _rand_log((3, 4), rng)
    b = _rand_log((4, 2), rng)
    b[:, 1] = -np.inf  # one output column fully blocked
    got = sr.LOG_SUM_EXP.contract([_t(a), _t(b)], [[0, 1], [1, 2]], [2]).numpy()
    assert np.isneginf(got[1])
    want0 = logsumexp(a[:, :, None] + b[None, :, :], axis=(0, 1))[0]
    np.testing.assert_allclose(got[0], want0, rtol=1e-10)


def test_log_einsum_all_neg_inf_operand(low_threshold):
    """A non-finite max shifts by 0, and y == 0 gives -inf, never NaN."""
    a = np.full((3, 4), -np.inf)
    b = np.zeros((4, 2))
    got = sr.LOG_SUM_EXP.contract([_t(a), _t(b)], [[0, 1], [1, 2]], [2]).numpy()
    assert np.all(np.isneginf(got))


def test_small_scope_uses_exact_path():
    """Below the threshold the element-exact reduce path is kept."""
    assert sr.LOG_EINSUM_MIN_STATES == jax_sr.LOG_EINSUM_MIN_STATES == 1 << 16
    rng = np.random.default_rng(2)
    a = _rand_log((2, 3), rng)
    b = _rand_log((3, 2), rng)
    got = sr.LOG_SUM_EXP.contract([_t(a), _t(b)], [[0, 1], [1, 2]], [2]).numpy()
    want = logsumexp(a[:, :, None] + b[None, :, :], axis=(0, 1))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_semiring_elementwise_ops():
    x, y = _t([0.5, 2.0]), _t([0.25, 4.0])
    for s, js in ((sr.SUM_PRODUCT, jax_sr.SUM_PRODUCT),
                  (sr.LOG_SUM_EXP, jax_sr.LOG_SUM_EXP),
                  (sr.MAX_PRODUCT, jax_sr.MAX_PRODUCT)):
        assert (s.name, s.is_log, s.one) == (js.name, js.is_log, js.one)
        for op in ("combine", "divide"):
            np.testing.assert_allclose(
                getattr(s, op)(x, y).numpy(),
                np.asarray(getattr(js, op)(x.numpy(), y.numpy())), rtol=1e-12)
        for op in ("to_linear", "from_linear"):
            np.testing.assert_allclose(
                getattr(s, op)(x).numpy(),
                np.asarray(getattr(js, op)(x.numpy())), rtol=1e-12)
    assert set(sr.SEMIRINGS) == set(jax_sr.SEMIRINGS)


def test_sum_product_low_precision_accumulates_in_float32():
    """bf16 and f16 operands: the result is float32 and equals the float32
    contraction of the same (already rounded) values."""
    rng = np.random.default_rng(3)
    ops = [torch.as_tensor(rng.random(s), dtype=torch.float32)
           for s in ((4, 300), (300, 5), (5,))]
    ovs = [[0, 1], [1, 2], [2]]
    for low in (torch.bfloat16, torch.float16):
        rounded = [o.to(low) for o in ops]
        got = sr.SUM_PRODUCT.contract([rounded[0], ops[1], rounded[2]], ovs, [0])
        want = sr.SUM_PRODUCT.contract(
            [rounded[0].float(), ops[1], rounded[2].float()], ovs, [0])
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
        assert sr.SUM_PRODUCT.contract([rounded[0]], [[0, 1]], [0]).dtype \
            == torch.float32


def _log_masks(masks):
    return {k: np.where(m > 0, 0.0, -np.inf) for k, m in masks.items()}


@pytest.mark.parametrize("name", ["log_sum_exp", "max_product"])
@pytest.mark.parametrize("big_scope", [False, True])
def test_log_engine_posterior_matches_jax(name, big_scope, monkeypatch):
    """``posterior_batch`` of a log-space engine against the JAX engine of
    that semiring (both float64, rtol 1e-8), with the log-matmul-exp branch
    on and off.  Row 1 is impossible: the JAX package returns NaN posteriors
    there, the port zeros and logZ = -inf."""
    if big_scope:
        monkeypatch.setattr(sr, "LOG_EINSUM_MIN_STATES", 1)
        monkeypatch.setattr(jax_sr, "LOG_EINSUM_MIN_STATES", 1)
    factors, sizes, values = grid_mrf_model(4, 4, seed=6)
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, 5, list(sizes)[:4], seed=7)
    masks = jt.batch_masks_sparse(tree.plan, evs, sr.SEMIRINGS[name])
    masks[list(sizes)[0]][1] = -np.inf
    eng = tree.engine(name, device="cpu", dtype=torch.float64) \
        .set_potentials(values)
    post, logz = eng.posterior_batch(masks)
    jeng = jt_jax.Engine(
        jt_jax.create_junction_tree(factors, sizes).plan,
        jt_jax.SEMIRINGS[name],
    ).set_potentials(values)
    jpost, jlogz = jeng.posterior_batch(masks, mode="general")
    rows = [0, 2, 3, 4]
    assert torch.isneginf(logz[1]) and np.isneginf(np.asarray(jlogz)[1])
    np.testing.assert_allclose(logz.numpy()[rows], np.asarray(jlogz)[rows],
                               rtol=1e-8)
    for p, jp in zip(post, jpost):
        assert (p[1] == 0).all() and not torch.isnan(p).any()
        np.testing.assert_allclose(p.numpy()[rows], np.asarray(jp)[rows],
                                   rtol=1e-8, atol=1e-12)


def test_log_engine_posterior_big_scope(low_threshold):
    """End to end: the log-space engine's posteriors match the linear
    engine's (rtol 1e-8 / atol 1e-12 in float64)."""
    factors, sizes, values = grid_mrf_model(4, 4, seed=6)
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, 5, list(sizes)[:4], seed=7)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    log_masks = jt.batch_masks_sparse(tree.plan, evs, jt.LOG_SUM_EXP)
    kw = dict(device="cpu", dtype=torch.float64)
    lin_eng = jt.Engine(tree.plan, jt.SUM_PRODUCT, **kw).set_potentials(values)
    log_eng = jt.Engine(tree.plan, jt.LOG_SUM_EXP, **kw).set_potentials(values)
    p1, z1 = lin_eng.posterior_batch(masks, mode="general")
    p2, z2 = log_eng.posterior_batch(log_masks, mode="general")
    np.testing.assert_allclose(z2.numpy(), z1.numpy(), rtol=1e-9)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("name", ["log_sum_exp", "max_product"])
def test_log_parity_paths_match_jax(name):
    """``propagate``, ``query`` and ``query_batch`` in a log semiring
    against the JAX package (float64, rtol 1e-8)."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=1)
    tree = jt.create_junction_tree(factors, sizes)
    jtree = jt_jax.create_junction_tree(factors, sizes)
    got = tree.propagate(values, name, device="cpu")
    want = jtree.propagate(values, semiring=name)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-8)
    eng = tree.engine(name, device="cpu", dtype=torch.float64) \
        .set_potentials(values)
    jeng = jtree.engine(name).set_potentials(values)
    ev = {"g0_0": 1, "g2_1": 0}
    margs, z = eng.query(ev)
    jmargs, jz = jeng.query(ev)
    np.testing.assert_allclose(z, jz, rtol=1e-8)
    for m, jm in zip(margs, jmargs):
        np.testing.assert_allclose(m, np.asarray(jm), rtol=1e-8, atol=1e-14)
    masks = jt.batch_masks_sparse(tree.plan, [ev, {}, {"g1_1": 1}],
                                  sr.SEMIRINGS[name])
    qm, qz = eng.query_batch(masks)
    jqm, jqz = jeng.query_batch(masks)
    np.testing.assert_allclose(qz.numpy(), np.asarray(jqz), rtol=1e-8)
    for m, jm in zip(qm, jqm):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-8)


def test_max_product_posterior_on_sprinkler_matches_query():
    """One max-product posterior: ``posterior_batch`` equals ``query``
    (max-marginals scaled to a max of 1 against max-marginals normalized to
    sum 1: compare after rescaling), rtol 1e-6 in float32."""
    factors, sizes, values = sprinkler_model()
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine("max_product", device="cpu").set_potentials(values)
    ev = {"wet_grass": 1}
    post, _ = eng.posterior_batch(
        jt.batch_masks_sparse(tree.plan, [ev], jt.MAX_PRODUCT))
    margs, _ = eng.query(ev)
    for p, m in zip(post, margs):
        np.testing.assert_allclose(p[0].numpy(), m / m.max(), rtol=1e-6)


def test_engine_rejects_unknown_semiring_and_rescale_off_sum_product():
    from junctiontree_tpu_torch.executor import BatchedProgramBuilder

    factors, sizes, _ = sprinkler_model()
    tree = jt.create_junction_tree(factors, sizes)
    with pytest.raises(ValueError, match="semiring"):
        tree.engine("min_sum", device="cpu")
    with pytest.raises(ValueError, match="semiring"):
        jt.Engine(tree.plan, sr.Semiring("other", True, 0.0), device="cpu")
    with pytest.raises(ValueError, match="rescale=True"):
        BatchedProgramBuilder(tree.plan, jt.LOG_SUM_EXP, rescale=True)
    with pytest.raises(ValueError, match="sum_product"):
        tree.engine("log_sum_exp", device="cpu").set_potentials(
            [np.ones(tuple(sizes[v] for v in f)) for f in factors]
        ).posterior_batch({}, mode="fused")
