"""The port's incremental evidence sessions (``incremental.py``,
``Engine.incremental``) against the JAX package's sessions on the same
evidence and deltas, and against a full ``posterior_batch`` under the merged
evidence.

Both packages run in float64 on the CPU.  Tolerances: posteriors and logZ
rtol 1e-9 / atol 1e-12 between the packages and against the port's own full
program (the cached rescale offsets keep logZ exact)."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.config import DEFAULT as JAX_DEFAULT
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.models import chain_bn_model, grid_mrf_model
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS

TOL = dict(rtol=1e-9, atol=1e-12)


def engines(factors, sizes, values, dtype=torch.float64):
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=dtype).set_potentials(values)
    ref = jt_jax.create_junction_tree(factors, sizes).engine().set_potentials(values)
    return eng, ref


def setup(rows=4, cols=4, B=6, n_obs=5, seed=0):
    factors, sizes, values = grid_mrf_model(rows, cols, seed=seed)
    eng, ref = engines(factors, sizes, values)
    observed = list(sizes)[:n_obs]
    evs = jt.random_evidence_batch(eng.plan, B, observed, seed=seed + 1)
    masks = jt.batch_masks_sparse(eng.plan, evs)
    return eng, ref, masks, sizes


def check_delta(eng, ref, sess, ref_sess, base, updates, qvars):
    """One delta through both sessions and the port's full program."""
    got_posts, got_logz = sess.query(updates, qvars)
    ref_posts, ref_logz = ref_sess.query(updates, qvars)
    merged = dict(base)
    merged.update(updates)
    full_posts, full_logz = eng.posterior_batch(merged, mode="general")
    B = next(iter(updates.values())).shape[0]
    assert tuple(got_logz.shape) == (B,)
    np.testing.assert_allclose(got_logz.numpy(), np.asarray(ref_logz), **TOL)
    np.testing.assert_allclose(got_logz.numpy(), full_logz.numpy(), **TOL)
    for v, got, want in zip(qvars, got_posts, ref_posts):
        assert tuple(got.shape) == (B, eng.plan.sizes[eng.plan.table.id_of(v)])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(
            got.numpy(), full_posts[eng.plan.table.id_of(v)].numpy(), **TOL
        )


def test_single_delta_matches_full_and_jax():
    eng, ref, masks, sizes = setup()
    sess, ref_sess = eng.incremental(masks), ref.incremental(masks)
    assert isinstance(sess, jt.IncrementalSession)
    dirty = next(iter(masks))
    new_mask = np.zeros_like(masks[dirty])
    new_mask[:, 1] = 1.0  # flip the observation to state 1
    qvars = [list(sizes)[7], list(sizes)[12], dirty]
    check_delta(eng, ref, sess, ref_sess, masks, {dirty: new_mask}, qvars)
    # the static step lists are cached per (dirty set, query set)
    n = len(sess._delta_cache)
    sess.query({dirty: new_mask}, qvars)
    assert len(sess._delta_cache) == n == 1


def test_delta_on_unobserved_variable():
    """A delta may observe a variable outside the base observed set."""
    eng, ref, masks, sizes = setup()
    names = list(sizes)
    newvar = names[-1]
    assert newvar not in masks
    B = next(iter(masks.values())).shape[0]
    m = np.zeros((B, sizes[newvar]), dtype=np.float32)
    m[:, 0] = 1.0
    check_delta(eng, ref, eng.incremental(masks), ref.incremental(masks),
                masks, {newvar: m}, [names[3]])


def test_multi_delta_and_rebase():
    eng, ref, masks, sizes = setup(n_obs=6)
    names = list(sizes)
    sess, ref_sess = eng.incremental(masks), ref.incremental(masks)
    d1, d2 = names[0], names[3]
    B = masks[d1].shape[0]
    m1 = np.tile(np.array([[0.0, 1.0]], dtype=np.float32), (B, 1))
    m2 = np.tile(np.array([[1.0, 0.0]], dtype=np.float32), (B, 1))
    check_delta(eng, ref, sess, ref_sess, masks, {d1: m1, d2: m2}, [names[9]])
    # rebase folds the delta in; a further query starts from the new base
    sess.rebase({d1: m1})
    ref_sess.rebase({d1: m1})
    rebased = dict(masks)
    rebased[d1] = m1
    check_delta(eng, ref, sess, ref_sess, rebased, {d2: m2}, [names[9]])
    with pytest.raises(KeyError, match="observed set"):
        sess.rebase({names[-1]: m1})


def test_impossible_evidence_logz():
    """A delta that zeroes out all mass yields logZ = -inf, not NaN, and
    zero posteriors; a possible row beside it is untouched."""
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 2, "c": 2}
    values = [np.array([[1.0, 0.0], [0.0, 1.0]]),
              np.array([[1.0, 0.0], [0.0, 1.0]])]
    eng, ref = engines(factors, sizes, values)
    base = {"a": np.array([[1.0, 0.0], [1.0, 0.0]], dtype=np.float32)}
    # a=0 forces b=0 forces c=0; observing c=1 is impossible
    upd = {"c": np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.float32)}
    posts, logz = eng.incremental(base).query(upd, ["b"])
    _, ref_logz = ref.incremental(base).query(upd, ["b"])
    assert torch.isneginf(logz[0]) and np.isneginf(np.asarray(ref_logz)[0])
    assert float(logz[1]) == pytest.approx(0.0, abs=1e-12)
    assert not torch.isnan(posts[0]).any() and (posts[0][0] == 0).all()
    np.testing.assert_allclose(posts[0][1].numpy(), [1.0, 0.0], atol=1e-12)


def test_chain_depth_paths():
    """Deep chain: delta at one end, query at the other (longest paths)."""
    factors, sizes, values = chain_bn_model(40, seed=2)
    eng, ref = engines(factors, sizes, values)
    names = list(sizes)
    base = {names[5]: np.tile(np.array([[1.0, 0.0]], dtype=np.float32), (3, 1))}
    m = np.tile(np.array([[0.0, 1.0]], dtype=np.float32), (3, 1))
    check_delta(eng, ref, eng.incremental(base), ref.incremental(base),
                base, {names[0]: m}, [names[39]])


def test_query_keeps_the_callers_masks_and_validates():
    """The same update tensor serves repeated queries (nothing is donated
    or written), and wrong shapes, empty updates and non-sum-product
    engines are refused."""
    eng, _, masks, sizes = setup()
    sess = eng.incremental(masks)
    dirty = next(iter(masks))
    qvars = [list(sizes)[7], dirty]
    m = torch.tensor([[0.0, 1.0]], dtype=torch.float64).repeat(
        masks[dirty].shape[0], 1
    )
    keep = m.clone()
    p1, z1 = sess.query({dirty: m}, qvars)
    p2, z2 = sess.query({dirty: m}, qvars)
    assert torch.equal(m, keep) and torch.equal(z1, z2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    with pytest.raises(ValueError, match="at least one"):
        sess.query({}, qvars)
    with pytest.raises(ValueError, match="must be"):
        sess.query({dirty: np.ones((2, 2))}, qvars)
    log_eng = jt.Engine(eng.plan, jt.LOG_SUM_EXP, device="cpu")
    with pytest.raises(ValueError, match="sum_product"):
        log_eng.incremental({})


def test_session_from_numpy_carries_the_jax_sessions_state():
    """A port session built from the JAX session's cached collect messages
    and offsets (no collect pass of its own) answers deltas like the JAX
    one."""
    eng, ref, masks, sizes = setup(seed=3)
    ref_sess = ref.incremental(masks)
    ups = [None if u is None else np.asarray(u) for u in ref_sess._ups]
    offs = [None if o is None else np.asarray(o) for o in ref_sess._offs]
    sess = jt.session_from_numpy(eng, masks, ups, offs)
    own = eng.incremental(masks)
    for u, o, u2, o2 in zip(sess._ups, sess._offs, own._ups, own._offs):
        if u is not None:
            np.testing.assert_allclose(u.numpy(), u2.numpy(), **TOL)
            np.testing.assert_allclose(o.numpy(), o2.numpy(), **TOL)
    dirty = list(masks)[2]
    new_mask = np.zeros_like(masks[dirty])
    new_mask[:, 0] = 1.0
    check_delta(eng, ref, sess, ref_sess, masks, {dirty: new_mask},
                [list(sizes)[10], list(sizes)[1]])


def _tailed_hub():
    """A 10-variable dense hub with a two-variable tail on every hub
    variable."""
    rng = np.random.default_rng(8)
    hub = [f"h{i}" for i in range(10)]
    factors = [hub] + [[h] for h in hub] + [[h, f"t{i}"] for i, h in enumerate(hub)]
    sizes = {**{h: 2 for h in hub}, **{f"t{i}": 2 for i in range(10)}}
    values = [rng.random(tuple(sizes[v] for v in f)) + 0.1 for f in factors]
    return factors, sizes, values


def test_session_takes_the_big_clique_route(monkeypatch):
    """Thresholds lowered to 2^8: the session's collect or delta
    contractions on the hub go through the factored big-clique contraction
    (``make_contract`` reaches the same router as the serving program), in
    float32; results within rtol 1e-5 / atol 1e-6 of the JAX session and of
    the float64 session without the route."""
    factors, sizes, values = _tailed_hub()
    plain, _ = engines(factors, sizes, values)
    base = jt.batch_masks_sparse(plain.plan, jt.random_evidence_batch(
        plain.plan, 5, [f"t{i}" for i in range(0, 10, 2)] + ["h1"], seed=4))
    upd = {"t3": np.tile(np.array([[0.0, 1.0]], dtype=np.float32), (5, 1))}
    qvars = ["h0", "t8", "h7"]
    before = TIMERS.counters()["big_clique_sep_message.calls"]
    want_posts, want_logz = plain.incremental(base).query(upd, qvars)
    # 2^10 < 2^17
    assert TIMERS.counters()["big_clique_sep_message.calls"] == before

    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    monkeypatch.setattr(JAX_DEFAULT, "pallas_min_states", 1 << 8)
    eng, ref = engines(factors, sizes, values, dtype=torch.float32)
    sess = eng.incremental(base)
    opened = TIMERS.counters()["big_clique_sep_message.calls"] - before
    posts, logz = sess.query(upd, qvars)
    delta = TIMERS.counters()["big_clique_sep_message.calls"] - before - opened
    assert opened + delta > 0
    import junctiontree_tpu.ops.pallas_contract as jax_pc

    ref.set_potentials(values, dtype=np.float32)
    jax_pc.set_pallas_mode("interpret")
    try:
        ref_posts, ref_logz = ref.incremental(base).query(upd, qvars)
    finally:
        jax_pc.set_pallas_mode("auto")
    np.testing.assert_allclose(logz.numpy(), want_logz.numpy(), rtol=1e-5)
    np.testing.assert_allclose(logz.numpy(), np.asarray(ref_logz), rtol=1e-5)
    for got, want, rwant in zip(posts, want_posts, ref_posts):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(rwant), rtol=1e-5, atol=1e-6)
