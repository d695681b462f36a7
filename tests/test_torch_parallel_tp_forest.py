"""Tensor parallelism (``parallel/tp.py``, ``Engine.shard_model``) and forest
parallelism (``parallel/forest.py``) of the port, case for case with
``tests/test_parallel_tp_forest.py``: the JAX side on its 8 virtual CPU
devices, the port on a mesh of ``["cpu"] * 8``.  Engines run in float64 and
are held to each other at rtol 1e-9; the JAX package's factored contraction
returns float32 whatever its inputs (``preferred_element_type``), so the
contraction itself is held to it at the JAX test's rtol 1e-5.  Beyond the
JAX cases: R1 not divisible by the model axis (the padding), the per-device
size of a sharded clique's blocks, the refusal of incremental sessions, and
unbatched messages multiplied into the blocks."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
import junctiontree_tpu_torch.executor as ex
from junctiontree_tpu.parallel.forest import ForestEngine as JaxForestEngine
from junctiontree_tpu.parallel.forest import split_components as jax_split
from junctiontree_tpu.parallel.mesh import make_mesh as jax_make_mesh
from junctiontree_tpu.parallel.tp import (
    sharded_factored_contract as jax_sharded_contract,
)
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.models import grid_mrf_model
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS
from junctiontree_tpu_torch.parallel.forest import ForestEngine, split_components
from junctiontree_tpu_torch.parallel.mesh import make_mesh
from junctiontree_tpu_torch.parallel.tp import (
    ShardedPotential,
    sharded_factored_contract,
    tp_contract_fn,
)

from .util import brute_force_marginals

CPU8 = ["cpu"] * 8


def _mesh(n_batch, n_model):
    return make_mesh(n_batch=n_batch, n_model=n_model, devices=CPU8)


def _engine(plan, **kw):
    return jt.Engine(plan, device="cpu", dtype=torch.float64, **kw)


def test_sharded_factored_contract_matches_local():
    rng = np.random.default_rng(4)
    R1, R2, C, B = 32, 64, 16, 16
    pot, w1, w2 = (rng.random(s) for s in ((R1, R2, C), (B, R1), (B, R2)))
    want = fc.reference_factored_contract(
        *(torch.as_tensor(x) for x in (pot, w1, w2)))
    for n_batch, n_model in [(4, 2), (2, 4), (1, 8)]:
        got = sharded_factored_contract(
            _mesh(n_batch, n_model), *(torch.as_tensor(x) for x in (pot, w1, w2)))
        np.testing.assert_allclose(got, want, rtol=1e-12)
        jgot = jax_sharded_contract(
            jax_make_mesh(n_batch=n_batch, n_model=n_model), pot, w1, w2)
        np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-5, atol=1e-6)


def test_sharded_factored_contract_unsharded_batch():
    rng = np.random.default_rng(5)
    pot, w1, w2 = (rng.random(s) for s in ((8, 8, 4), (5, 8), (5, 8)))
    t = [torch.as_tensor(x) for x in (pot, w1, w2)]
    got = sharded_factored_contract(_mesh(1, 8), *t, shard_batch=False)
    np.testing.assert_allclose(got, fc.reference_factored_contract(*t),
                               rtol=1e-12)
    jgot = jax_sharded_contract(jax_make_mesh(n_batch=1, n_model=8), pot, w1,
                                w2, shard_batch=False)
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="does not split"):
        sharded_factored_contract(_mesh(2, 4), *t)   # 5 rows over 2


@pytest.mark.parametrize("R1,n_model", [(6, 4), (3, 8), (10, 4)])
def test_tp_contract_fn_pads_r1(R1, n_model):
    """R1 not a multiple of the model-axis size: ``sharded_factored_contract``
    refuses it, ``tp_contract_fn`` pads with zero rows that add nothing."""
    rng = np.random.default_rng(R1)
    t = [torch.as_tensor(rng.random(s)) for s in ((R1, 7, 3), (4, R1), (4, 7))]
    with pytest.raises(ValueError, match="multiple"):
        sharded_factored_contract(_mesh(1, n_model), *t)
    got = tp_contract_fn(_mesh(1, n_model))(*t)
    np.testing.assert_allclose(got, fc.reference_factored_contract(*t),
                               rtol=1e-12)


def _forest_model():
    # three disconnected components with different shapes + a scalar factor
    f1, s1, v1 = grid_mrf_model(2, 2, seed=1)
    factors = list(f1) + [["h", "i"], ["i"]] + [["z"]] + [[]]
    sizes = dict(s1, h=3, i=2, z=4)
    rng = np.random.default_rng(0)
    values = list(v1) + [rng.random((3, 2)) + 0.1, rng.random(2) + 0.1,
                         rng.random(4) + 0.1, np.array(2.0)]
    return factors, sizes, values


def test_split_components():
    factors, sizes, values = _forest_model()
    comps = split_components(factors, sizes)
    assert len(comps) == 3
    covered = sorted(i for c in comps for i in c[0])
    assert covered == list(range(len(factors)))
    assert comps == [tuple(c) for c in jax_split(factors, sizes)]


def test_forest_engine_matches_monolithic():
    factors, sizes, values = _forest_model()
    fe = ForestEngine(factors, sizes, devices=["cpu"]).set_potentials(values)
    evs = [{"g0_0": 1, "i": 0}, {"z": 2}, {}]
    post, logz = fe.posterior_batch(evs)

    # the monolithic engine (components joined by empty separators)
    plan = jt.compile_plan(factors, sizes)
    eng = jt.Engine(plan, device="cpu").set_potentials(values)
    post_m, logz_m = eng.posterior_batch(jt.batch_masks_sparse(plan, evs))
    np.testing.assert_allclose(logz, logz_m, rtol=1e-5)
    for v in sizes:
        assert post[v].shape == (3, sizes[v])
        np.testing.assert_allclose(post[v], post_m[plan.table.id_of(v)],
                                   rtol=1e-5, atol=1e-6)
    jpost, jlogz = JaxForestEngine(factors, sizes).set_potentials(values) \
        .posterior_batch(evs)
    np.testing.assert_allclose(logz, jlogz, rtol=1e-5)
    for v in sizes:
        np.testing.assert_allclose(post[v], jpost[v], rtol=1e-5, atol=1e-6)


def test_forest_engine_devices_spread(monkeypatch):
    """Components go round-robin over the devices given; with none given
    the default is the local CUDA devices, and without a card it raises."""
    factors, sizes, values = _forest_model()
    devs = [torch.device("cpu", i) for i in range(8)]
    fe = ForestEngine(factors, sizes, devices=devs).set_potentials(values)
    assert fe.device_of == devs[:3]
    assert len({str(d) for d in fe.device_of}) == 3
    _, logz = fe.posterior_batch([{"z": 1}])
    assert logz.shape == (1,) and torch.isfinite(logz).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ForestEngine(factors, sizes)


def _big_clique_model(nv=12, seed=0):
    """One clique of nv binary vars (2^nv states) + unary factors."""
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(nv)]
    factors = [names[:]] + [[n] for n in names]
    sizes = {n: 2 for n in names}
    values = [rng.random((2,) * nv).astype(np.float32) + 0.1] + [
        rng.random(2) + 0.1 for _ in names
    ]
    return factors, sizes, values


def _masks(names, B, seed):
    rng = np.random.default_rng(seed)
    masks = {}
    for n in names:
        m = np.zeros((B, 2), dtype=np.float32)
        m[np.arange(B), rng.integers(0, 2, B)] = 1.0
        masks[n] = m
    return masks


def _assert_post(post, logz, post0, logz0, n, rtol=1e-9):
    np.testing.assert_allclose(logz, np.asarray(logz0), rtol=rtol)
    for v in range(n):
        np.testing.assert_allclose(post[v], np.asarray(post0[v]), rtol=rtol,
                                   atol=1e-14)


@pytest.mark.parametrize("n_batch,n_model,shard_batch",
                         [(2, 4, False), (2, 4, True), (1, 8, False)])
def test_engine_shard_model_posterior_matches_unsharded(n_batch, n_model,
                                                        shard_batch):
    """``Engine.shard_model`` routes the oversized clique's contractions
    through the model-axis-sharded factored contraction: the same results
    as the unsharded engine and the JAX package's sharded engine."""
    factors, sizes, values = _big_clique_model(nv=12, seed=0)
    B = 8
    masks = _masks(list(sizes)[:7], B, seed=1)
    plan = jt.compile_plan(factors, sizes)
    post0, logz0 = _engine(plan).set_potentials(values).posterior_batch(masks)

    eng = _engine(plan)
    eng.shard_model(_mesh(n_batch, n_model), min_states=1 << 10,
                    shard_batch=shard_batch)
    eng.set_potentials(values)
    # the big clique's potential really is stored sharded over the model axis
    big = int(np.argmax([p.size for p in eng._pots_np]))
    sp = eng._pots[big]
    assert isinstance(sp, ShardedPotential)
    assert [s.numel() for s in sp.shards] == [4096 // n_model] * n_model
    calls = TIMERS.counters()["big_clique_sep_message.calls"]
    post, logz = eng.posterior_batch(masks)
    assert TIMERS.counters()["big_clique_sep_message.calls"] > calls
    _assert_post(post, logz, post0, logz0, len(sizes))
    assert eng.describe()["tp_fallbacks"] == []

    jeng = jt_jax.create_junction_tree(factors, sizes).engine()
    jeng.shard_model(jax_make_mesh(n_batch=n_batch, n_model=n_model),
                     min_states=1 << 10, shard_batch=shard_batch)
    jpost, jlogz = jeng.set_potentials(values).posterior_batch(masks)
    _assert_post(post, logz, jpost, jlogz, len(sizes), rtol=1e-5)


def test_engine_shard_model_scales_feasibility_cap():
    """With a model mesh, check_feasible's cap scales by n_model (oversized
    cliques shard instead of raising)."""
    factors, sizes, values = _big_clique_model(nv=10, seed=2)
    plan = jt.compile_plan(factors, sizes)
    with pytest.raises(ValueError, match="infeasible"):
        ex.check_feasible(plan, max_states=1 << 8)
    ex.check_feasible(plan, max_states=(1 << 8) * 8)

    # the single-query path also works on a shard_model engine
    eng = _engine(plan).shard_model(_mesh(1, 8), min_states=1 << 9)
    assert eng._feasible_cap() == ex.MAX_CLIQUE_STATES * 8
    eng.set_potentials(values)
    post, z = eng.query({"v0": 1})
    (oracle,) = brute_force_marginals(
        factors, sizes, values, [["v3"]], evidence={"v0": 1}
    )
    np.testing.assert_allclose(post[plan.table.id_of("v3")],
                               oracle / oracle.sum(), rtol=1e-9)


def test_engine_shard_model_rejects_nonlinear_semirings():
    factors, sizes, values = _big_clique_model(nv=6, seed=3)
    plan = jt.compile_plan(factors, sizes)
    for sr in (jt.LOG_SUM_EXP, jt.MAX_PRODUCT):
        with pytest.raises(ValueError, match="sum_product"):
            _engine(plan, semiring=sr).shard_model(_mesh(2, 4))


def test_shard_model_propagate_uses_scaled_cap(monkeypatch):
    """``Engine.propagate`` on a shard_model engine checks the scaled cap,
    not the single-device one."""
    factors, sizes, values = _big_clique_model(nv=10, seed=2)
    monkeypatch.setattr(ex, "MAX_CLIQUE_STATES", 1 << 9)  # 2^10 is oversized
    plan = jt.compile_plan(factors, sizes)
    eng = _engine(plan).shard_model(_mesh(4, 2), min_states=1 << 10)
    out = eng.propagate(values)
    assert len(out) == len(values)
    eng.set_potentials(values)   # the serving path too
    with pytest.raises(ValueError, match="infeasible"):
        _engine(plan).propagate(values)


def _tail_model(nv=10, seed=3):
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(nv)]
    factors = [names[:]] + [[n] for n in names] + [["tail0"], ["v0", "tail0"]]
    sizes = {n: 2 for n in names}
    sizes["tail0"] = 2
    values = (
        [rng.random((2,) * nv).astype(np.float32) + 0.1]
        + [rng.random(2) + 0.1 for _ in names]
        + [rng.random(2) + 0.1, rng.random((2, 2)) + 0.1]
    )
    return factors, sizes, values


def test_shard_model_unbatched_contraction_stays_sharded(monkeypatch):
    """Evidence nowhere near the big clique: its contractions have no
    batched operand and still run sharded (a unit batch of ones weights);
    the potential is never gathered onto one device."""
    factors, sizes, values = _tail_model()
    B = 4
    masks = {"tail0": np.tile(np.array([[1.0, 0.0]], np.float32), (B, 1))}
    plan = jt.compile_plan(factors, sizes)
    post0, logz0 = _engine(plan).set_potentials(values).posterior_batch(masks)

    eng = _engine(plan).shard_model(_mesh(2, 4), min_states=1 << 10)
    eng.set_potentials(values)

    def refuse(self):
        raise AssertionError("a sharded potential was gathered")

    monkeypatch.setattr(ShardedPotential, "gather", refuse)
    post, logz = eng.posterior_batch(masks)
    _assert_post(post, logz, post0, logz0, plan.num_vars)
    assert eng.describe().get("tp_fallbacks", []) == []

    jeng = jt_jax.create_junction_tree(factors, sizes).engine()
    jeng.shard_model(jax_make_mesh(n_batch=2, n_model=4), min_states=1 << 10)
    jpost, jlogz = jeng.set_potentials(values).posterior_batch(masks)
    _assert_post(post, logz, jpost, jlogz, plan.num_vars, rtol=1e-5)


@pytest.mark.parametrize("n_model,shard_batch", [(4, False), (2, True),
                                                 (8, False)])
def test_shard_model_blocks_stay_within_a_shard(monkeypatch, n_model,
                                                shard_batch):
    """No device receives more than ceil(R1/n) x R2 x C states of a sharded
    clique: the flat shards hold S/n each, every cached block of every
    layout at most ceil(R1/n) x R2 x C, and no contraction gathers the
    potential.  The tails' unbatched messages are multiplied into the
    blocks; results equal the unsharded engine's with the factored route
    taken at the same size."""
    rng = np.random.default_rng(11)
    nv = 10
    names = [f"v{i}" for i in range(nv)]
    tails = [f"t{i}" for i in range(nv)]
    factors = [names[:]] + [[n, t] for n, t in zip(names, tails)]
    sizes = {n: 2 for n in names + tails}
    sizes["t3"] = 3
    values = [rng.random((2,) * nv) + 0.1] + [
        rng.random((2, sizes[t])) + 0.1 for t in tails]
    plan = jt.compile_plan(factors, sizes)
    evs = jt.random_evidence_batch(plan, 8, names[:3] + tails[5:7], seed=2)
    masks = jt.batch_masks_sparse(plan, evs)
    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 9)
    post0, logz0 = _engine(plan).set_potentials(values).posterior_batch(masks)

    mesh = _mesh(2 if shard_batch else 1, n_model)
    eng = _engine(plan).shard_model(mesh, min_states=1 << 9,
                                    shard_batch=shard_batch)
    eng.set_potentials(values)
    monkeypatch.setattr(ShardedPotential, "gather", None)
    post, logz = eng.posterior_batch(masks)
    _assert_post(post, logz, post0, logz0, plan.num_vars)
    big = int(np.argmax([p.size for p in eng._pots_np]))
    sp = eng._pots[big]
    assert [s.numel() for s in sp.shards] == [1024 // n_model] * n_model
    assert sp._blocks, "no layout was cut"
    for (axes, r2_first, _, _), blk in sp._blocks.items():
        R1 = int(np.prod([sp.shape[a] for a in axes[0]]))
        cap = -(-R1 // n_model) * 1024 // R1
        assert blk.numel() <= cap, (axes, tuple(blk.shape))
    assert eng.describe()["tp_fallbacks"] == []


def test_shard_model_crossing_message_gathers_with_a_note():
    """A child message that crosses the separator cannot be factored: the
    contraction gathers the potential onto the engine's device, says so in
    ``describe()["tp_fallbacks"]``, and the results stay exact."""
    rng = np.random.default_rng(4)
    names = [f"v{i}" for i in range(10)]
    factors = [names[:], ["v0", "v1", "t"], ["v1", "v2", "u"], ["t"]]
    sizes = {n: 2 for n in names + ["t", "u"]}
    values = [rng.random((2,) * 10) + 0.1, rng.random((2, 2, 2)) + 0.1,
              rng.random((2, 2, 2)) + 0.1, rng.random(2) + 0.1]
    plan = jt.compile_plan(factors, sizes)
    masks = _masks(["t", "u", "v5"], 4, seed=6)
    post0, logz0 = _engine(plan).set_potentials(values).posterior_batch(masks)
    eng = _engine(plan).shard_model(_mesh(1, 4), min_states=1 << 10)
    post, logz = eng.set_potentials(values).posterior_batch(masks)
    _assert_post(post, logz, post0, logz0, plan.num_vars)
    notes = eng.describe()["tp_fallbacks"]
    assert notes and all("crosses the separator" in n for n in notes)


def test_shard_model_indivisible_above_cap_raises(monkeypatch):
    """A mixed-cardinality oversized clique that cannot be flat-sharded
    raises above the single-device cap, and is placed whole with a note
    below it."""
    rng = np.random.default_rng(5)
    names = [f"c{i}" for i in range(7)]
    factors = [names[:]] + [[n] for n in names]
    sizes = {n: 3 for n in names}  # 3^7 = 2187 states, never divisible by 4
    values = [rng.random((3,) * 7).astype(np.float32) + 0.1] + [
        rng.random(3) + 0.1 for _ in names
    ]
    plan = jt.compile_plan(factors, sizes)
    monkeypatch.setattr(ex, "MAX_CLIQUE_STATES", 1 << 10)
    eng = _engine(plan).shard_model(_mesh(2, 4), min_states=1 << 10)
    with pytest.raises(ValueError, match="not divisible"):
        eng.set_potentials(values)
    monkeypatch.setattr(ex, "MAX_CLIQUE_STATES", 1 << 12)
    eng = _engine(plan).shard_model(_mesh(2, 4), min_states=1 << 10)
    eng.set_potentials(values)
    assert not any(isinstance(p, ShardedPotential) for p in eng._pots)
    assert any("not divisible" in n for n in eng.describe()["tp_fallbacks"])
    masks = {"c0": np.eye(3)[[0, 2]]}
    post, logz = eng.posterior_batch(masks)
    post0, logz0 = _engine(plan).set_potentials(values).posterior_batch(masks)
    _assert_post(post, logz, post0, logz0, plan.num_vars)


def test_incremental_session_refuses_model_sharded_engines():
    factors, sizes, values = _big_clique_model(nv=8, seed=1)
    plan = jt.compile_plan(factors, sizes)
    eng = _engine(plan).shard_model(_mesh(1, 4), min_states=1 << 6)
    eng.set_potentials(values)
    with pytest.raises(ValueError, match="model-sharded"):
        eng.incremental({"v0": np.ones((2, 2))})


def test_tp_min_states_setting_matches_jax():
    from junctiontree_tpu.config import DEFAULT as JAX_DEFAULT

    assert DEFAULT.tp_min_states == JAX_DEFAULT.tp_min_states == 1 << 26
    eng = _engine(jt.compile_plan(*_big_clique_model(nv=4)[:2]))
    assert eng.shard_model(_mesh(1, 2))._tp_min_states == 1 << 26
