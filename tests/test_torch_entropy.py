"""The port's posterior entropy (``Engine.entropy``, ``entropy_batch``,
``executor.batched_entropy_program``) against the JAX package on the same
models and evidence, and against the enumerated joint.

Both packages run in float64 on the CPU.  Tolerances: entropies and Z rtol
1e-9 (atol 1e-12) between the packages, abs 1e-6 / rel 1e-6 against the
enumeration (as ``tests/test_entropy.py``).  The route test lowers the
big-clique threshold of both packages so that every entropy term goes
through the factored big-clique contraction (the JAX package runs its
Pallas kernel in interpret mode; the port its plain version on the CPU)."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu.ops.pallas_contract as jax_pc
import junctiontree_tpu_torch as jt
from junctiontree_tpu.config import DEFAULT as JAX_DEFAULT
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS

from .util import brute_force_marginals, grid_mrf, random_factor_graph, random_values

RTOL, ATOL = 1e-9, 1e-12


def oracle_entropy(factors, sizes, values, evidence=None):
    all_vars = sorted({v for f in factors for v in f}, key=str)
    joint = brute_force_marginals(factors, sizes, values, [all_vars], evidence)[0]
    z = joint.sum()
    p = (joint / z).ravel()
    nz = p[p > 0]
    return float(-(nz * np.log(nz)).sum()), float(z)


def engines(factors, sizes, values, semiring=jt.SUM_PRODUCT, dtype=torch.float64):
    eng = jt.Engine(
        jt.compile_plan(factors, sizes), semiring, device="cpu", dtype=dtype
    ).set_potentials(values)
    ref = jt_jax.Engine(
        jt_jax.compile_plan(factors, sizes), jt_jax.SEMIRINGS[semiring.name]
    ).set_potentials(values)
    return eng, ref


def log_masks(eng, m):
    """Linear masks in the engine's semiring space."""
    if not eng.semiring.is_log:
        return m
    with np.errstate(divide="ignore"):
        return np.log(m)


@pytest.mark.parametrize("semiring", [jt.SUM_PRODUCT, jt.LOG_SUM_EXP])
def test_entropy_matches_bruteforce_and_jax(semiring):
    factors, sizes = random_factor_graph(2, n_vars=7, n_factors=9)
    values = random_values(factors, sizes, seed=3)
    eng, ref = engines(factors, sizes, values, semiring)
    v0 = sorted(sizes)[0]
    for ev in (None, {v0: 1}):
        h, z = eng.entropy(ev)
        h0, z0 = oracle_entropy(factors, sizes, values, ev)
        assert h == pytest.approx(h0, abs=1e-6)
        assert z == pytest.approx(z0, rel=1e-6)
        hj, zj = ref.entropy(ev)
        np.testing.assert_allclose([h, z], [hj, zj], rtol=RTOL, atol=ATOL)


def test_entropy_uniform_and_deterministic():
    """Uniform joint -> ln(prod sizes); point-mass posterior -> 0."""
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 3, "c": 4}
    eng, _ = engines(factors, sizes, [np.ones((2, 3)), np.ones((3, 4))])
    h, z = eng.entropy()
    assert h == pytest.approx(np.log(2 * 3 * 4), abs=1e-12)
    # deterministic chain: b == f(a), c == f(b), a observed -> H = 0
    sizes2 = {"a": 2, "b": 2, "c": 2}
    eng2, ref2 = engines(factors, sizes2, [np.eye(2), np.eye(2)])
    h, z = eng2.entropy({"a": 0})
    assert h == pytest.approx(0.0, abs=1e-12)
    assert z == pytest.approx(1.0, rel=1e-12)
    np.testing.assert_allclose(ref2.entropy({"a": 0}), (h, z), atol=1e-12)


@pytest.mark.parametrize("semiring", [jt.SUM_PRODUCT, jt.LOG_SUM_EXP])
def test_entropy_batch(semiring):
    """Both probability semirings: Z comes back in LINEAR space."""
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=8)
    eng, ref = engines(factors, sizes, values, semiring)
    m = np.ones((3, 2), dtype=np.float32)
    m[0] = [1.0, 0.0]
    m[1] = [0.0, 1.0]
    masks = {"g0_0": log_masks(eng, m)}
    ents, zs = eng.entropy_batch(masks)
    assert ents.dtype == zs.dtype == torch.float64
    assert tuple(ents.shape) == tuple(zs.shape) == (3,)
    ej, zj = ref.entropy_batch(masks)
    np.testing.assert_allclose(ents.numpy(), np.asarray(ej), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(zs.numpy(), np.asarray(zj), rtol=RTOL, atol=ATOL)
    for b, ev in enumerate([{"g0_0": 0}, {"g0_0": 1}, None]):
        h0, z0 = oracle_entropy(factors, sizes, values, ev)
        assert float(ents[b]) == pytest.approx(h0, abs=1e-6)
        assert float(zs[b]) == pytest.approx(z0, rel=1e-6)
        # the per-element form agrees with the batched one
        h1, z1 = eng.entropy(ev)
        np.testing.assert_allclose([h1, z1], [float(ents[b]), float(zs[b])],
                                   rtol=1e-9)


def test_entropy_batch_full_mask_list_on_log_engine():
    """A full per-variable mask list, and an impossible row (H = 0, Z = 0,
    no NaN), on the log engine's per-element form."""
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=2)
    eng, _ = engines(factors, sizes, values, jt.LOG_SUM_EXP)
    plan = eng.plan
    full = [np.zeros((2, plan.sizes[v])) for v in range(plan.num_vars)]
    full[plan.table.id_of("g0_0")][0] = -np.inf
    ents, zs = eng.entropy_batch(full)
    assert not torch.isnan(ents).any() and not torch.isnan(zs).any()
    assert float(ents[0]) == 0.0 and float(zs[0]) == 0.0
    h0, z0 = oracle_entropy(factors, sizes, values)
    assert float(ents[1]) == pytest.approx(h0, abs=1e-9)
    assert float(zs[1]) == pytest.approx(z0, rel=1e-9)


def test_entropy_batch_on_log_engine_through_log_matmul_exp(monkeypatch):
    """With the log-einsum threshold at 1 every several-operand contraction
    of the per-element form takes the max-shifted linear einsum, under
    ``torch.vmap``: the same entropies and Z as the JAX package (rtol 1e-9)
    and an impossible row of H = 0, Z = 0."""
    import junctiontree_tpu.ops.semirings as jax_sr
    from junctiontree_tpu_torch.ops import semirings as sr

    monkeypatch.setattr(sr, "LOG_EINSUM_MIN_STATES", 1)
    monkeypatch.setattr(jax_sr, "LOG_EINSUM_MIN_STATES", 1)
    taken = []
    inner = sr._log_matmul_exp
    monkeypatch.setattr(
        sr, "_log_matmul_exp", lambda *a: taken.append(1) or inner(*a))
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=5)
    eng, ref = engines(factors, sizes, values, jt.LOG_SUM_EXP)
    m = np.ones((4, 2))
    m[0], m[1] = [1.0, 0.0], [0.0, 1.0]
    dead = np.ones((4, 2))
    dead[2] = 0.0
    masks = {"g0_0": log_masks(eng, m), "g2_1": log_masks(eng, dead)}
    ents, zs = eng.entropy_batch(masks)
    assert taken
    assert not torch.isnan(ents).any() and not torch.isnan(zs).any()
    assert float(ents[2]) == 0.0 and float(zs[2]) == 0.0
    ej, zj = ref.entropy_batch(masks)
    np.testing.assert_allclose(ents.numpy(), np.asarray(ej), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(zs.numpy(), np.asarray(zj), rtol=RTOL, atol=ATOL)
    h0, z0 = oracle_entropy(factors, sizes, values)
    assert float(ents[3]) == pytest.approx(h0, abs=1e-6)
    assert float(zs[3]) == pytest.approx(z0, rel=1e-6)


def test_entropy_rejects_max_product():
    factors = [["a", "b"]]
    sizes = {"a": 2, "b": 2}
    eng, _ = engines(factors, sizes, [np.ones((2, 2))], jt.MAX_PRODUCT)
    with pytest.raises(ValueError, match="probability semiring"):
        eng.entropy()
    with pytest.raises(ValueError, match="probability semiring"):
        eng.entropy_batch({})


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_entropy_batch_impossible_and_structural_zeros(dtype):
    """The routed entropy program (operand-log decomposition, no per-element
    beliefs) handles structural zeros (op*log(op) -> 0) and
    impossible-evidence elements (H = 0, Z = 0, no NaN).  A bfloat16 engine
    computes entropy in float32."""
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=9)
    pair_ix = next(i for i, f in enumerate(factors) if len(f) == 2)
    values[pair_ix][:, 0] = 0.0  # structural zero
    eng, ref = engines(factors, sizes, values, dtype=dtype)
    m = np.ones((3, 2), dtype=np.float32)
    m[0] = [0.0, 0.0]   # impossible
    m[1] = [1.0, 0.0]
    ents, zs = eng.entropy_batch({"g0_0": m})
    want = torch.float64 if dtype is torch.float64 else torch.float32
    assert ents.dtype == zs.dtype == want
    ents, zs = ents.double().numpy(), zs.double().numpy()
    assert not np.isnan(ents).any() and not np.isnan(zs).any()
    assert ents[0] == 0.0 and zs[0] == 0.0
    ej, zj = ref.entropy_batch({"g0_0": m})
    tol = dict(rtol=RTOL, atol=ATOL) if dtype is torch.float64 \
        else dict(rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(ents, np.asarray(ej), **tol)
    np.testing.assert_allclose(zs, np.asarray(zj), **tol)
    for b, ev in [(1, {"g0_0": 0}), (2, None)]:
        h0, z0 = oracle_entropy(factors, sizes, values, ev)
        assert ents[b] == pytest.approx(h0, abs=1e-5)
        assert zs[b] == pytest.approx(z0, rel=1e-5)


def test_xlogx_is_zero_at_zero_and_keeps_subnormals():
    from junctiontree_tpu_torch.executor import _xlogx

    x = torch.tensor([0.0, 1e-38, 1e-45, 1.0, 2.0], dtype=torch.float32)
    y = _xlogx(x)
    assert y[0] == 0.0 and y[3] == 0.0 and torch.isfinite(y).all()
    assert y[1] < 0 and y[2] < 0  # 1e-38 and 1e-45 are not flushed
    np.testing.assert_allclose(float(y[4]), 2 * np.log(2), rtol=1e-6)


def _hub_model():
    """A 10-variable dense hub (2^10 states) with three two-variable tails
    and a unary on every hub variable."""
    rng = np.random.default_rng(5)
    hub = [f"h{i}" for i in range(10)]
    factors = [hub] + [[h] for h in hub] + [[hub[i], f"t{i}"] for i in range(3)]
    sizes = {**{h: 2 for h in hub}, **{f"t{i}": 2 for i in range(3)}}
    values = [rng.random(tuple(sizes[v] for v in f)) + 0.1 for f in factors]
    return factors, sizes, values


def test_entropy_batch_takes_the_big_clique_route(monkeypatch):
    """Thresholds lowered to 2^8: the hub's entropy terms (one contraction
    to [] per operand, one with ``xlogx`` of the potential) go through the
    factored big-clique contraction in both packages, float32; rtol 1e-4
    between them and against the port's float64 run without the route."""
    factors, sizes, values = _hub_model()
    rng = np.random.default_rng(1)
    masks = {}
    for v in ("t0", "t2", "h4", "h5", "h6", "h9"):
        m = np.zeros((6, 2), dtype=np.float32)
        m[np.arange(6), rng.integers(0, 2, 6)] = 1.0
        masks[v] = m
    masks["h4"][3] = 1.0  # one row leaves h4 unobserved
    plain, _ = engines(factors, sizes, values)
    before = TIMERS.counters()["big_clique_sep_message.calls"]
    want_h, want_z = plain.entropy_batch(masks)
    # 2^10 < 2^17
    assert TIMERS.counters()["big_clique_sep_message.calls"] == before

    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    monkeypatch.setattr(JAX_DEFAULT, "pallas_min_states", 1 << 8)
    eng = jt.Engine(
        jt.compile_plan(factors, sizes), device="cpu", dtype=torch.float32
    ).set_potentials(values)
    got_h, got_z = eng.entropy_batch(masks)
    routed = TIMERS.counters()["big_clique_sep_message.calls"] - before
    # the hub: 1 + its operands; the collect, distribute and Z steps besides
    assert routed > 5
    np.testing.assert_allclose(got_h.numpy(), want_h.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got_z.numpy(), want_z.numpy(), rtol=1e-4)

    jax_kernel_calls = []
    kernel = jax_pc.factored_masked_contract

    def spy(*args, **kw):
        jax_kernel_calls.append(kw.get("interpret"))
        return kernel(*args, **kw)

    monkeypatch.setattr(jax_pc, "factored_masked_contract", spy)
    jax_pc.set_pallas_mode("interpret")
    try:
        ref = jt_jax.Engine(jt_jax.compile_plan(factors, sizes)).set_potentials(
            values, dtype=np.float32
        )
        ref_h, ref_z = ref.entropy_batch(masks)
    finally:
        jax_pc.set_pallas_mode("auto")
    assert jax_kernel_calls and all(jax_kernel_calls)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), rtol=1e-4)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(ref_z), rtol=1e-4)
