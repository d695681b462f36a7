"""bfloat16 storage of the port's serving program (``dtype=torch.bfloat16``
or ``config.storage_dtype = "bfloat16"``): posteriors within bf16 tolerance
of the float32 engine and of the JAX package's bf16 engine, float32 outputs,
float32 parity paths, log engines unaffected, and the big-clique route taken
with bf16 operands.  Limits are the JAX package's own (``tests/test_bf16.py``):
posteriors atol 0.02, logZ atol 0.05."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.config import DEFAULT as JAX_DEFAULT
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.executor import _PROG_TINY, BatchedProgramBuilder
from junctiontree_tpu_torch.models import grid_mrf_model
from junctiontree_tpu_torch.ops import factored_contract as fc


def _grid_case(B=16):
    factors, sizes, values = grid_mrf_model(6, 6, seed=3)
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, B, list(sizes)[:8], seed=4)
    return factors, sizes, values, tree, jt.batch_masks_sparse(tree.plan, evs)


def _np(post, logz):
    return [p.numpy() for p in post], logz.numpy()


def test_bf16_posterior_parity_grid(monkeypatch):
    factors, sizes, values, tree, masks = _grid_case()
    eng16 = tree.engine(device="cpu", dtype=torch.bfloat16).set_potentials(values)
    assert eng16.storage_dtype() == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in eng16._program_pots())
    post, logz = eng16.posterior_batch(masks, mode="general")
    # outputs are f32 regardless of storage
    assert logz.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in post)
    got, logz16 = _np(post, logz)
    eng32 = tree.engine(device="cpu", dtype=torch.float32).set_potentials(values)
    want, logz32 = _np(*eng32.posterior_batch(masks, mode="general"))
    np.testing.assert_allclose(logz16, logz32, rtol=0, atol=0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=0.02)
    # and against the JAX package's bf16 engine
    monkeypatch.setattr(JAX_DEFAULT, "storage_dtype", "bfloat16")
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    jpost, jlogz = jeng.posterior_batch(masks, mode="general")
    np.testing.assert_allclose(logz16, np.asarray(jlogz), rtol=0, atol=0.05)
    for g, jp in zip(got, jpost):
        np.testing.assert_allclose(g, np.asarray(jp), atol=0.02)


def test_bf16_from_config_default(monkeypatch):
    """``config.storage_dtype`` is the engine's default dtype."""
    monkeypatch.setattr(DEFAULT, "storage_dtype", "bfloat16")
    factors, sizes, values = grid_mrf_model(2, 2, seed=0)
    eng = jt.create_junction_tree(factors, sizes).engine(device="cpu")
    assert eng.dtype == torch.bfloat16 and eng.compute_dtype == torch.float32
    post, logz = eng.set_potentials(values).posterior_batch({})
    assert logz.dtype == torch.float32 and post[0].dtype == torch.float32
    with pytest.raises(ValueError, match="dtype"):
        jt.Engine(eng.plan, device="cpu", dtype=torch.float16)


def test_bf16_messages_stored_in_bf16_logz_accumulated_in_f32(monkeypatch):
    """The rescaled messages are bf16, the maxima they were divided by and
    the logZ offsets float32: spy on the program's rescaling."""
    factors, sizes, values, tree, masks = _grid_case(B=4)
    seen = []

    def spying(name):
        inner = getattr(BatchedProgramBuilder, name)

        def spy(self, st, *args):
            m, storage = args[-4], args[-1]
            out = inner(self, st, *args)
            seen.append((name, m.dtype, out.dtype, st[("logoff",)].dtype))
            assert storage == torch.bfloat16
            return out

        monkeypatch.setattr(BatchedProgramBuilder, name, spy)

    spying("_collect_scale")
    spying("_distribute_scale")
    tree.engine(device="cpu", dtype=torch.bfloat16).set_potentials(values) \
        .posterior_batch(masks, mode="general")
    assert set(seen) == {
        (name, torch.float32, torch.bfloat16, torch.float32)
        for name in ("_collect_scale", "_distribute_scale")}


def test_bf16_impossible_evidence_keeps_the_contract():
    """The floor 1e-38 is subnormal in bf16 too: maxima are clamped in f32
    before the store, so an impossible row still gives zero posteriors and
    logZ = -inf, never NaN; the other rows stay within tolerance."""
    assert torch.tensor(_PROG_TINY, dtype=torch.bfloat16) > 0
    _, _, values, tree, masks = _grid_case(B=6)
    first = next(iter(masks))
    masks[first][1] = 0.0
    post, logz = tree.engine(device="cpu", dtype=torch.bfloat16) \
        .set_potentials(values).posterior_batch(masks, mode="general")
    want, logz32 = tree.engine(device="cpu", dtype=torch.float32) \
        .set_potentials(values).posterior_batch(masks, mode="general")
    assert torch.isneginf(logz[1]) and torch.isneginf(logz32[1])
    rows = [0, 2, 3, 4, 5]
    np.testing.assert_allclose(logz[rows], logz32[rows], rtol=0, atol=0.05)
    for p, w in zip(post, want):
        assert not torch.isnan(p).any() and (p[1] == 0).all()
        np.testing.assert_allclose(p[rows], w[rows], atol=0.02)


def test_bf16_leaves_parity_paths_f32():
    """propagate, query and query_batch of a bf16 engine compute in f32 and
    equal the f32 engine's bit for bit."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=1)
    tree = jt.create_junction_tree(factors, sizes)
    e16 = tree.engine(device="cpu", dtype=torch.bfloat16).set_potentials(values)
    e32 = tree.engine(device="cpu", dtype=torch.float32).set_potentials(values)
    for g, w in zip(e16.propagate(values), e32.propagate(values)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    (m16, z16), (m32, z32) = e16.query({"g0_0": 1}), e32.query({"g0_0": 1})
    assert z16 == z32 and all(np.array_equal(a, b) for a, b in zip(m16, m32))
    masks = jt.batch_masks_sparse(tree.plan, [{"g0_0": 1}, {"g1_1": 0}])
    (q16, zq16), (q32, zq32) = e16.query_batch(masks), e32.query_batch(masks)
    assert zq16.dtype == torch.float32 and torch.equal(zq16, zq32)
    assert all(torch.equal(a, b) for a, b in zip(q16, q32))


@pytest.mark.parametrize("semiring", ["log_sum_exp", "max_product"])
def test_bf16_log_engine_unaffected(semiring):
    """log-space engines keep f32 storage (bf16 logsumexp loses the tail)."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=2)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(semiring, device="cpu", dtype=torch.bfloat16) \
        .set_potentials(values)
    assert eng.storage_dtype() == torch.float32
    assert all(p.dtype == torch.float32 for p in eng._program_pots())
    ref = tree.engine(semiring, device="cpu", dtype=torch.float32) \
        .set_potentials(values)
    masks = jt.batch_masks_sparse(
        tree.plan, [{"g0_0": 1}], jt.SEMIRINGS[semiring])
    (p, z), (rp, rz) = eng.posterior_batch(masks), ref.posterior_batch(masks)
    assert torch.equal(z, rz) and all(torch.equal(a, b) for a, b in zip(p, rp))


def test_bf16_chain_and_fused_programs_compute_in_f32():
    """bf16 storage applies to the general program only."""
    from junctiontree_tpu_torch.models import chain_bn_model, star_bn_model

    for model, mode in ((chain_bn_model(12, seed=3), "auto"),
                        (star_bn_model(8), "fused")):
        factors, sizes, values = model
        tree = jt.create_junction_tree(factors, sizes)
        masks = jt.batch_masks_sparse(tree.plan, [{list(sizes)[2]: 1}, {}])
        e16 = tree.engine(device="cpu", dtype=torch.bfloat16).set_potentials(values)
        e32 = tree.engine(device="cpu", dtype=torch.float32).set_potentials(values)
        (p, z), (rp, rz) = (e.posterior_batch(masks, mode=mode) for e in (e16, e32))
        assert torch.equal(z, rz)
        assert all(torch.equal(p[v], rp[v]) for v in range(len(sizes)))


def test_bf16_big_clique_routed(monkeypatch):
    """A big-clique model routes through the factored contraction with bf16
    pot and w2 (on the CPU: the plain version, which accumulates in f32) and
    matches the f32 answer and the JAX bf16 engine within bf16 tolerance."""
    rng = np.random.default_rng(0)
    nv = 12
    names = [f"v{i}" for i in range(nv)]
    tails = [[names[i], f"t{i}"] for i in range(3)]
    factors = [names[:]] + [[n] for n in names] + tails
    sizes = {**{n: 2 for n in names}, **{f"t{i}": 2 for i in range(3)}}
    values = [rng.random((2,) * nv).astype(np.float32) + 0.1] + [
        rng.random(2) + 0.1 for _ in names
    ] + [rng.random((2, 2)) + 0.1 for _ in tails]
    B = 8
    masks = {}
    for n in names[:5] + ["t0", "t1"]:
        m = np.zeros((B, 2), dtype=np.float32)
        m[np.arange(B), rng.integers(0, 2, B)] = 1.0
        masks[n] = m
    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 10)
    monkeypatch.setattr(JAX_DEFAULT, "pallas_min_states", 1 << 10)
    seen = []
    plain = fc.reference_factored_contract

    def spy(pot, w1, w2):
        seen.append((pot.dtype, w2.dtype))
        return plain(pot, w1, w2)

    monkeypatch.setattr(fc, "reference_factored_contract", spy)
    tree = jt.create_junction_tree(factors, sizes)
    got, logz16 = _np(*tree.engine(device="cpu", dtype=torch.bfloat16)
                      .set_potentials(values).posterior_batch(masks))
    assert len(seen) >= 4 and set(seen) == {(torch.bfloat16, torch.bfloat16)}
    want, logz32 = _np(*tree.engine(device="cpu", dtype=torch.float32)
                       .set_potentials(values).posterior_batch(masks))
    np.testing.assert_allclose(logz16, logz32, rtol=0, atol=0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=0.02)
    monkeypatch.setattr(JAX_DEFAULT, "storage_dtype", "bfloat16")
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    jpost, jlogz = jeng.posterior_batch(masks, mode="general")
    np.testing.assert_allclose(logz16, np.asarray(jlogz), rtol=0, atol=0.05)
    for g, jp in zip(got, jpost):
        np.testing.assert_allclose(g, np.asarray(jp), atol=0.02)


def test_bf16_potential_merged_with_unbatched_messages_stays_bf16(monkeypatch):
    """A hub whose unobserved tails send unbatched messages: the route first
    multiplies them into the hub's potential, and that product is stored in
    bfloat16 like the potential, so the contraction reads bf16 pot and w2."""
    rng = np.random.default_rng(4)
    hub = [f"h{i}" for i in range(10)]
    factors = [hub] + [[h] for h in hub] + [[hub[i], f"t{i}"] for i in range(4)]
    sizes = {**{h: 2 for h in hub}, **{f"t{i}": 2 for i in range(4)}}
    values = [rng.random(tuple(sizes[v] for v in f)) + 0.1 for f in factors]
    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, 6, ["h5", "h6", "h7"], seed=2)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    seen, merged = [], []
    plain = fc.reference_factored_contract
    monkeypatch.setattr(
        fc, "reference_factored_contract",
        lambda pot, w1, w2: seen.append((pot.dtype, w2.dtype)) or plain(pot, w1, w2))
    from junctiontree_tpu_torch import executor

    route = executor.big_clique_sep_message

    def spy(pot, scope, *a, **kw):
        merged.append(pot.dtype)
        return route(pot, scope, *a, **kw)

    monkeypatch.setattr(executor, "big_clique_sep_message", spy)
    got, logz16 = _np(*tree.engine(device="cpu", dtype=torch.bfloat16)
                      .set_potentials(values).posterior_batch(masks))
    assert seen and set(seen) == {(torch.bfloat16, torch.bfloat16)}
    assert set(merged) == {torch.bfloat16}
    want, logz32 = _np(*tree.engine(device="cpu", dtype=torch.float32)
                       .set_potentials(values).posterior_batch(masks))
    np.testing.assert_allclose(logz16, logz32, rtol=0, atol=0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=0.02)
