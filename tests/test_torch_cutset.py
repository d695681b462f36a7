"""``junctiontree_tpu_torch.cutset`` case for case with
``tests/test_cutset.py``.

The port's ``CutsetEngine`` runs in float64 against the port's monolithic
``Engine`` in float64 and the brute force (rtol 1e-9), and in float32
against the JAX package's float32 ``CutsetEngine`` on the same arrays (rtol
1e-4, atol 1e-6: the JAX package's own limits against its monolithic
engine).  Impossible evidence is held to the contract (zero posteriors,
logZ = -inf) in every mode, on reduced and on cutset variables: the JAX
package returns about -1e30 for a cutset variable there, so that row is not
compared with it."""

import numpy as np
import pytest
import torch

import junctiontree_tpu_torch as jt
from junctiontree_tpu import cutset as jcutset
from junctiontree_tpu_torch import CutsetEngine, choose_cutset
from junctiontree_tpu_torch.cutset import _max_states, _without
from junctiontree_tpu_torch.models import grid_mrf_model, hailfinder_like

from .test_cutset import _enum_mpe
from .util import brute_force_marginals

F64 = dict(device="cpu", dtype=torch.float64)
MODES = ("auto", "message", "fused")


def _monolithic(factors, sizes, values, masks):
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(**F64).set_potentials(values)
    posts, logz = eng.posterior_batch(masks, mode="general")
    return {v: posts[tree.plan.table.id_of(v)].numpy() for v in sizes}, logz.numpy()


def _same(got, logz, want, want_logz, rtol, atol):
    np.testing.assert_allclose(np.asarray(logz), np.asarray(want_logz), rtol=rtol)
    assert set(got) == set(want)
    for v in want:
        np.testing.assert_allclose(
            np.asarray(got[v]), np.asarray(want[v]), rtol=rtol, atol=atol,
            err_msg=str(v))


def _against_jax(factors, sizes, values, cutset, masks, mode="auto"):
    """The float32 port beside the JAX package's engine on the same arrays."""
    jce = jcutset.CutsetEngine(factors, sizes, values, cutset=cutset)
    ce = jt.cutset_engine_from_numpy(
        jce.factors, jce.sizes, jce._values, jce.cutset, device="cpu")
    assert ce.plan.to_json() == jce.plan.to_json()
    got, logz = ce.posterior_batch(masks, mode=mode)
    want, want_logz = jce.posterior_batch(masks, mode=mode)
    _same(got, logz, want, want_logz, 1e-4, 1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_cutset_matches_monolithic_grid(mode):
    factors, sizes, values = grid_mrf_model(4, 4, seed=1)
    names = list(sizes)
    plan = jt.compile_plan(factors, sizes)
    masks = jt.batch_masks_sparse(
        plan, jt.random_evidence_batch(plan, 5, names[:3], seed=2))
    cut = [names[0], names[9]]  # a nontrivial cutset incl. an observed variable
    ce = CutsetEngine(factors, sizes, values, cutset=cut, **F64)
    got, logz = ce.posterior_batch(masks, mode=mode)
    want, want_logz = _monolithic(factors, sizes, values, masks)
    _same(got, logz, want, want_logz, 1e-9, 1e-12)
    _against_jax(factors, sizes, values, cut, masks, mode)


def test_cutset_evidence_on_cutset_variable():
    factors, sizes, values = grid_mrf_model(3, 3, seed=4)
    names = list(sizes)
    B = 3
    cut = names[4]
    m = np.zeros((B, sizes[cut]), dtype=np.float32)
    m[:, 0] = 1.0
    m2 = np.tile(np.array([[0.25, 1.0]], dtype=np.float32), (B, 1))  # soft
    masks = {cut: m, names[1]: m2}
    ce = CutsetEngine(factors, sizes, values, cutset=[cut], **F64)
    got, logz = ce.posterior_batch(masks)
    want, want_logz = _monolithic(factors, sizes, values, masks)
    _same(got, logz, want, want_logz, 1e-9, 1e-12)
    np.testing.assert_allclose(got[cut].numpy()[:, 0], np.ones(B), atol=1e-12)
    _against_jax(factors, sizes, values, [cut], masks)


def test_choose_cutset_shrinks_dense_model():
    factors, sizes, values = hailfinder_like()
    cut = choose_cutset(factors, sizes, target_states=1 << 14, max_enum=512)
    assert cut == jcutset.choose_cutset(
        factors, sizes, target_states=1 << 14, max_enum=512)
    before = _max_states(factors, sizes)
    after = _max_states(*_without(factors, sizes, set(cut)))
    assert after < before / 50, (before, after, cut)


def test_cutset_mpe_matches_enumeration():
    factors, sizes, values = grid_mrf_model(3, 3, seed=6)
    names = list(sizes)
    evidence = {names[1]: 1, names[4]: 0}  # names[4] is a cutset variable
    cut = [names[4], names[7]]
    ce = CutsetEngine(factors, sizes, values, cutset=cut, **F64)
    got, score = ce.map_assignment(evidence)
    want, want_score = _enum_mpe(factors, sizes, values, evidence)
    np.testing.assert_allclose(score, want_score, rtol=1e-9)
    p = 1.0
    for f, val in zip(factors, values):
        p *= float(np.asarray(val)[tuple(got[v] for v in f)])
    np.testing.assert_allclose(np.log(p), want_score, rtol=1e-9)
    for v, s in evidence.items():
        assert got[v] == s
    jgot, jscore = jcutset.CutsetEngine(
        factors, sizes, values, cutset=cut).map_assignment(evidence)
    np.testing.assert_allclose(score, jscore, rtol=1e-5)
    assert got == jgot


def test_cutset_mpe_batch_matches_monolithic():
    factors, sizes, values = grid_mrf_model(3, 4, seed=8)
    names = list(sizes)
    B = 4
    rng = np.random.default_rng(3)
    masks = {}
    for v in (names[0], names[5]):
        m = np.zeros((B, sizes[v]), dtype=np.float32)
        m[np.arange(B), rng.integers(0, sizes[v], B)] = 1.0
        masks[v] = m
    masks[names[5]][3] = 0.0  # an infeasible row, on a cutset variable
    cut = [names[5], names[6]]
    ce = CutsetEngine(factors, sizes, values, cutset=cut, **F64)
    got, scores = ce.map_assignment_batch(masks)
    assert all(a.dtype == np.int32 and a.shape == (B,) for a in got.values())
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine("max_product", **F64).set_potentials(values)
    logmasks = {k: np.where(m > 0, 0.0, -np.inf).astype(np.float32)
                for k, m in masks.items()}
    assign_w, scores_w = eng.map_assignment_batch(logmasks)
    np.testing.assert_allclose(scores[:3], scores_w.numpy()[:3], rtol=1e-9)
    assert scores[3] < -1e29 and float(scores_w[3]) < -1e29
    for b in range(3):
        p_got = sum(
            float(np.log(np.asarray(val)[tuple(got[v][b] for v in f)]))
            for f, val in zip(factors, values)
        )
        np.testing.assert_allclose(p_got, scores[b], rtol=1e-9)
    jgot, jscores = jcutset.CutsetEngine(
        factors, sizes, values, cutset=cut).map_assignment_batch(masks)
    np.testing.assert_allclose(scores[:3], np.asarray(jscores)[:3], rtol=1e-5)


@pytest.mark.parametrize("trial", range(6))
def test_cutset_fuzz_vs_oracle(trial):
    """Random small factor graphs x random cutsets x random (hard+soft)
    evidence: posteriors, logZ and MPE all match brute force, in every
    mode."""
    rng = np.random.default_rng(42 + trial)
    nv = int(rng.integers(4, 8))
    names = [f"v{i}" for i in range(nv)]
    sizes = {v: int(rng.integers(2, 4)) for v in names}
    factors = [[v] for v in names]
    for _ in range(int(rng.integers(nv, 2 * nv))):
        k = int(rng.integers(2, min(4, nv) + 1))
        scope = list(rng.choice(nv, size=k, replace=False))
        factors.append([names[i] for i in sorted(scope)])
    values = [rng.random(tuple(sizes[v] for v in f)) + 0.05 for f in factors]
    n_cut = int(rng.integers(1, 3))
    cutset = [names[i] for i in rng.choice(nv, n_cut, replace=False)]
    ce = CutsetEngine(factors, sizes, values, cutset=cutset, state_chunk=2, **F64)
    B = 3
    masks = {}
    for v in [names[i] for i in rng.choice(nv, 2, replace=False)]:
        if rng.random() < 0.5:  # hard
            m = np.zeros((B, sizes[v]), dtype=np.float32)
            m[np.arange(B), rng.integers(0, sizes[v], B)] = 1.0
        else:  # soft likelihood
            m = rng.random((B, sizes[v])).astype(np.float32) + 0.1
        masks[v] = m
    for mode in MODES:
        posts, logz = ce.posterior_batch(masks, mode=mode)
        for b in range(B):
            bf = [list(f) for f in factors] + [[v] for v in masks]
            bv = list(values) + [np.asarray(masks[v][b], dtype=np.float64)
                                 for v in masks]
            *margs, Z = brute_force_marginals(
                bf, sizes, bv, [[v] for v in names] + [[]])
            np.testing.assert_allclose(float(logz[b]), np.log(Z), rtol=1e-9)
            for v, m in zip(names, margs):
                np.testing.assert_allclose(
                    posts[v].numpy()[b], m / m.sum(), rtol=1e-8, atol=1e-12,
                    err_msg=f"{mode} row {b} var {v}")
    hard_ev = {
        v: int(np.argmax(masks[v][0]))
        for v in masks if set(np.unique(masks[v][0])) <= {0.0, 1.0}
    }
    got, score = ce.map_assignment(hard_ev)
    want, want_score = _enum_mpe(factors, sizes, values, hard_ev)
    np.testing.assert_allclose(score, want_score, rtol=1e-9)


def test_cutset_engine_hailfinder_class():
    """End to end on the dense BN class in float32, as it is served: small
    reduced cliques, finite logZ, normalized posteriors for every variable
    incl. the cutset, against the monolithic engine."""
    factors, sizes, values = hailfinder_like()
    ce = CutsetEngine(factors, sizes, values, target_states=1 << 14,
                      max_enum=512, device="cpu")
    st = ce.describe()
    assert st["max_clique_states"] <= 1 << 16
    assert st["cutset_states"] <= 512 and st["cutset"] == ce.cutset
    names = list(sizes)
    B = 2
    rng = np.random.default_rng(0)
    masks = {}
    for v in names[::7]:
        m = np.zeros((B, sizes[v]), dtype=np.float32)
        m[np.arange(B), rng.integers(0, sizes[v], B)] = 1.0
        masks[v] = m
    got, logz = ce.posterior_batch(masks)
    assert bool(torch.isfinite(logz).all()) and set(got) == set(sizes)
    for v in sizes:
        a = got[v].numpy()
        assert a.shape == (B, sizes[v])
        np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-4)
    for v in masks:
        state = np.argmax(masks[v], axis=1)
        np.testing.assert_allclose(got[v].numpy()[np.arange(B), state], 1.0, atol=1e-4)
    # the chunk arithmetic: clique-sized buffers under the budget
    states = st["max_clique_states"]
    assert ce._chunk_for(B) == max(1, min(ce.num_states, (8 << 30) // (4 * B * states * 2), 256))
    assert ce._chunk_for(B, "message") == max(
        1, min(ce.num_states, (8 << 30) // (4 * B * states * 3), 256))
    assert not ce._fused_routing()


def test_cutset_fused_evidence_only_on_cutset():
    factors, sizes, values = grid_mrf_model(3, 3, seed=6)
    names = list(sizes)
    cut = names[4]
    B = 3
    m = np.zeros((B, sizes[cut]), dtype=np.float32)
    m[:, 1] = 1.0
    masks = {cut: m}
    ce = CutsetEngine(factors, sizes, values, cutset=[cut], **F64)
    pf, zf = ce.posterior_batch(masks, mode="fused")
    pu, zu = ce.posterior_batch(masks)
    _same(pf, zf, pu, zu, 1e-9, 1e-12)
    _against_jax(factors, sizes, values, [cut], masks, "fused")


def test_cutset_fused_soft_evidence_on_cutset():
    factors, sizes, values = grid_mrf_model(4, 4, seed=3)
    names = list(sizes)
    plan = jt.compile_plan(factors, sizes)
    B = 4
    masks = jt.batch_masks_sparse(
        plan, jt.random_evidence_batch(plan, B, names[:2], seed=7))
    cut = [names[0], names[5]]
    masks[cut[1]] = (
        np.random.default_rng(1).random((B, sizes[cut[1]])).astype(np.float32) + 0.1
    )
    ce = CutsetEngine(factors, sizes, values, cutset=cut, **F64)
    pf, zf = ce.posterior_batch(masks, mode="fused")
    want, want_logz = _monolithic(factors, sizes, values, masks)
    _same(pf, zf, want, want_logz, 1e-9, 1e-12)
    _against_jax(factors, sizes, values, cut, masks, "fused")


def test_cutset_fused_structural_check_and_parity():
    # regular: v -> hub -> 40 identical leaves; cutting v leaves a star
    sizes = {"v": 3, "hub": 2}
    factors = []
    for i in range(40):
        sizes[f"leaf{i}"] = 2
        factors.append(["v", "hub", f"leaf{i}"])
    rng = np.random.default_rng(11)
    values = [rng.random((3, 2, 2)) + 0.05 for _ in factors]
    ce = CutsetEngine(factors, sizes, values, cutset=["v"], **F64)
    assert ce.num_states == 3 and ce._fused_routing()
    masks = {"leaf0": np.tile(np.array([[1.0, 0.0]], dtype=np.float32), (3, 1))}
    pf, zf = ce.posterior_batch(masks, mode="fused")
    pu, zu = ce.posterior_batch(masks)  # auto = unrolled
    _same(pf, zf, pu, zu, 1e-9, 1e-12)


@pytest.mark.parametrize("where", ["reduced", "cutset"])
def test_cutset_impossible_evidence_zero_posteriors(where):
    """Zero posteriors and logZ = -inf, never NaN and never -1e30, in every
    mode, whether the impossible mask sits on a reduced variable or on a
    cutset variable; possible rows of the same batch agree with the
    monolithic engine."""
    factors, sizes, values = grid_mrf_model(4, 4, seed=0)
    names = list(sizes)
    B = 3
    ce = CutsetEngine(factors, sizes, values, cutset=[names[5]], **F64)
    bad = names[0] if where == "reduced" else names[5]
    for mode in MODES:
        out, logz = ce.posterior_batch(
            {bad: np.zeros((B, 2), dtype=np.float32)}, mode=mode)
        assert bool(torch.isneginf(logz).all()), mode
        for v, p in out.items():
            assert bool((p == 0).all()), (mode, v)
    m = np.ones((B, 2), dtype=np.float32)
    m[1] = 0.0
    want, want_logz = _monolithic(factors, sizes, values, {bad: m})
    for mode in MODES:
        out, logz = ce.posterior_batch({bad: m}, mode=mode)
        logz = logz.numpy()
        assert np.isneginf(logz[1]) and np.isneginf(want_logz[1])
        np.testing.assert_allclose(logz[[0, 2]], want_logz[[0, 2]], rtol=1e-9)
        for v, p in out.items():
            arr = p.numpy()
            assert not np.isnan(arr).any() and (arr[1] == 0).all(), (mode, v)
            np.testing.assert_allclose(arr[[0, 2]], want[v][[0, 2]], rtol=1e-9,
                                       atol=1e-12)


def test_cutset_errors_and_device_default(monkeypatch):
    factors, sizes, values = grid_mrf_model(3, 3, seed=0)
    ce = CutsetEngine(factors, sizes, values, cutset=[list(sizes)[4]], device="cpu")
    with pytest.raises(ValueError, match="mode"):
        ce.posterior_batch({list(sizes)[0]: np.ones((1, 2))}, mode="nope")
    with pytest.raises(ValueError, match="evidence mask"):
        ce.posterior_batch({})
    assert ce._chunk_for(4) >= 1 and CutsetEngine(
        factors, sizes, values, cutset=[list(sizes)[4]], state_chunk=1,
        device="cpu")._chunk_for(4) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CutsetEngine(factors, sizes, values, cutset=[list(sizes)[4]])
