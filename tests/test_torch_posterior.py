"""The serving path ``Engine.posterior_batch`` of the port against the JAX
package's general batched program on the same plan and the same evidence,
including impossible rows, the factored big-clique route, and an engine
carried across with ``convert.engine_from_numpy``."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.config import DEFAULT as JAX_DEFAULT
from junctiontree_tpu.ops import pallas_contract as jax_pc
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.models import alarm_like, grid_mrf_model, insurance_like
from junctiontree_tpu_torch.ops import factored_contract as fc


def _masks(plan, B, labels, seed):
    """Sparse evidence masks on ``labels``; row 1 is made impossible by an
    all-zero mask and row 3 has no evidence at all."""
    evs = jt.random_evidence_batch(plan, B, labels, seed=seed)
    evs[3] = {}
    masks = jt.batch_masks_sparse(plan, evs)
    masks[labels[0]][1] = 0.0
    return masks


def _assert_matches_jax(post, logz, jpost, jlogz, rtol, atol, rows=None):
    """The port's impossible row 1 gives zero posteriors and logZ = -inf;
    ``rows`` (default: all) agree with the JAX package."""
    logz = logz.cpu().numpy()
    jlogz = np.asarray(jlogz)
    rows = np.arange(len(logz)) if rows is None else np.asarray(rows)
    assert np.isneginf(logz[1]) and np.isneginf(jlogz[1])
    finite = rows[np.isfinite(jlogz[rows])]
    np.testing.assert_allclose(logz[finite], jlogz[finite], rtol=rtol, atol=atol)
    for p, jp in zip(post, jpost):
        p = p.cpu().numpy()
        assert not np.isnan(p).any()
        assert (p[1] == 0).all()
        np.testing.assert_allclose(
            p[rows], np.asarray(jp)[rows], rtol=rtol, atol=atol
        )


@pytest.mark.parametrize("name", ["grid4x4", "alarm", "insurance"])
def test_posterior_batch_matches_jax(name):
    factors, sizes, values = {
        "grid4x4": lambda: grid_mrf_model(4, 4, seed=2),
        "alarm": lambda: alarm_like(seed=1),
        "insurance": lambda: insurance_like(seed=2),
    }[name]()
    tree = jt.create_junction_tree(factors, sizes)
    labels = list(sizes)[::3]
    masks = _masks(tree.plan, 6, labels, seed=5)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    post, logz = eng.posterior_batch(masks)
    assert logz.dtype == torch.float64 and tuple(logz.shape) == (6,)
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    jpost, jlogz = jeng.posterior_batch(masks, mode="general")
    _assert_matches_jax(post, logz, jpost, jlogz, rtol=1e-9, atol=1e-12)
    # the evidence-free row is the prior, and rows are normalized
    for p in post:
        np.testing.assert_allclose(p[[0, 2, 3, 4, 5]].sum(-1).numpy(), 1.0)


def _hub_model():
    """A 12-variable dense hub (2^12 states) with four two-variable tails:
    the tails' messages enter the hub's contractions as batched operands."""
    rng = np.random.default_rng(4)
    hub = [f"h{i}" for i in range(12)]
    factors = [hub] + [[h] for h in hub] + [[hub[i], f"t{i}"] for i in range(4)]
    sizes = {**{h: 2 for h in hub}, **{f"t{i}": 2 for i in range(4)}}
    values = [rng.random(tuple(sizes[v] for v in f)) + 0.1 for f in factors]
    return factors, sizes, values


def test_big_clique_route_matches_jax_kernel(monkeypatch):
    """Thresholds lowered to 2^8: both packages route the hub's
    contractions through the factored contraction (JAX: the Pallas kernel in
    interpret mode; the port: its plain version on the CPU), in f32.

    The JAX package's f32 program on the CPU returns NaN posteriors for the
    impossible row (XLA flushes the subnormal floor 1e-38 to zero, with or
    without the kernel route), so that row is held to the contract only."""
    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    monkeypatch.setattr(JAX_DEFAULT, "pallas_min_states", 1 << 8)
    factors, sizes, values = _hub_model()
    tree = jt.create_junction_tree(factors, sizes)
    labels = ["t0", "t1", "t2", "h5", "h6", "h7"]
    masks = _masks(tree.plan, 8, labels, seed=9)
    before = fc.big_clique_sep_message.calls
    eng = tree.engine(device="cpu", dtype=torch.float32).set_potentials(values)
    post, logz = eng.posterior_batch(masks)
    assert fc.big_clique_sep_message.calls > before
    jax_kernel_calls = []
    kernel = jax_pc.factored_masked_contract

    def spy(*args, **kw):
        jax_kernel_calls.append(kw.get("interpret"))
        return kernel(*args, **kw)

    monkeypatch.setattr(jax_pc, "factored_masked_contract", spy)
    jax_pc.set_pallas_mode("interpret")
    try:
        jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
            .set_potentials(values, dtype=np.float32)
        jpost, jlogz = jeng.posterior_batch(masks, mode="general")
    finally:
        jax_pc.set_pallas_mode("auto")
    assert jax_kernel_calls and all(jax_kernel_calls)
    _assert_matches_jax(post, logz, jpost, jlogz, rtol=1e-5, atol=1e-6,
                        rows=[0, 2, 3, 4, 5, 6, 7])


def test_engine_from_numpy_serves_the_jax_state():
    factors, sizes, values = alarm_like(seed=4)
    jtree = jt_jax.create_junction_tree(factors, sizes)
    jeng = jtree.engine().set_potentials(values)
    eng = jt.engine_from_numpy(
        jtree.plan.to_json(), jeng._pots_np, device="cpu", dtype=torch.float64
    )
    assert eng.plan.to_json() == jtree.plan.to_json()
    masks = _masks(eng.plan, 5, list(sizes)[1::4], seed=3)
    post, logz = eng.posterior_batch(masks)
    jpost, jlogz = jeng.posterior_batch(masks, mode="general")
    _assert_matches_jax(post, logz, jpost, jlogz, rtol=1e-9, atol=1e-12)
    margs, z = eng.query({"n2": 1})
    jmargs, jz = jeng.query({"n2": 1})
    np.testing.assert_allclose(z, jz, rtol=1e-9)
    for m, jm in zip(margs, jmargs):
        np.testing.assert_allclose(m, np.asarray(jm), rtol=1e-9, atol=1e-15)


def test_posterior_modes():
    factors, sizes, values = grid_mrf_model(2, 2, seed=0)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu").set_potentials(values)
    masks = jt.batch_masks(tree.plan, [{"g0_0": 1}, {}])
    a, za = eng.posterior_batch(masks, mode="auto")
    b, zb = eng.posterior_batch(masks, mode="general")
    assert torch.equal(za, zb) and all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.posterior_batch(masks, mode="fused")
    with pytest.raises(ValueError, match=r"\[B, 2\]"):
        eng.posterior_batch({"g0_0": np.ones((2, 3))})
