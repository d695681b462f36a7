"""The port's engine checkpoints and introspection (``Engine.save`` /
``load``, ``describe``, ``max_feasible_batch``) against the JAX package:
a ``.npz`` written by either package loads in the other and serves the same
numbers (float64 on the CPU, rtol 1e-12 for potentials and queries after a
round trip, rtol 1e-9 between the packages), and ``max_feasible_batch`` is
the same arithmetic on the same plan."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.models import chain_bn_model, grid_mrf_model
from junctiontree_tpu_torch.utils.timing import TIMERS

from .util import grid_mrf, random_values


def engine(factors, sizes, values, semiring="sum_product", dtype=torch.float64):
    return jt.create_junction_tree(factors, sizes).engine(
        semiring, device="cpu", dtype=dtype
    ).set_potentials(values)


@pytest.mark.parametrize("semiring", ["sum_product", "log_sum_exp", "max_product"])
def test_engine_checkpoint_roundtrip(tmp_path, semiring):
    """save/load restores the full serving state: identical queries without
    re-triangulation or re-evaluation, in every semiring."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=6)
    eng = engine(factors, sizes, values, semiring)
    p = str(tmp_path / f"eng_{semiring}.npz")
    eng.save(p)
    with np.load(p, allow_pickle=False) as d:
        assert set(d.files) == {"__plan__", "__semiring__"} | {
            f"pot_{i}" for i in range(eng.plan.tri.num_cliques)}
    eng2 = jt.Engine.load(p, device="cpu", dtype=torch.float64)
    assert eng2.semiring.name == semiring
    assert eng2.plan.to_json() == eng.plan.to_json()
    assert eng2.device == torch.device("cpu") and eng2.dtype == torch.float64
    want_m, want_z = eng.query({"g0_0": 1})
    got_m, got_z = eng2.query({"g0_0": 1})
    np.testing.assert_allclose(got_z, want_z, rtol=1e-12)
    for a, b in zip(got_m, want_m):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    masks = jt.batch_masks_sparse(eng.plan, [{"g0_0": 1}, {"g1_1": 0}], eng.semiring)
    post, logz = eng.posterior_batch(masks)
    post2, logz2 = eng2.posterior_batch(masks)
    assert torch.equal(logz, logz2)
    assert all(torch.equal(a, b) for a, b in zip(post, post2))


def test_save_needs_potentials_and_load_refuses_pickles(tmp_path):
    factors, sizes, _ = grid_mrf_model(2, 2, seed=0)
    eng = jt.Engine(jt.compile_plan(factors, sizes), device="cpu")
    with pytest.raises(RuntimeError, match="set_potentials"):
        eng.save(str(tmp_path / "no.npz"))
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, __plan__=np.array([{"a": 1}], dtype=object))
    with pytest.raises(ValueError):
        jt.Engine.load(bad, device="cpu")


@pytest.mark.parametrize("semiring", ["sum_product", "log_sum_exp"])
def test_checkpoint_written_by_jax_loads_in_the_port_and_back(tmp_path, semiring):
    factors, sizes, values = grid_mrf_model(3, 4, seed=2)
    jeng = jt_jax.create_junction_tree(factors, sizes).engine(
        semiring).set_potentials(values)
    from_jax = str(tmp_path / "jax.npz")
    jeng.save(from_jax)
    eng = jt.Engine.load(from_jax, device="cpu", dtype=torch.float64)
    assert eng.semiring.name == semiring
    assert eng.plan.to_json() == jeng.plan.to_json()
    for p, q in zip(eng._pots_np, jeng._pots_np):
        np.testing.assert_array_equal(p, q)
    ev = {"g0_0": 1, "g2_3": 0}
    m, z = eng.query(ev)
    jm, jz = jeng.query(ev)
    np.testing.assert_allclose(z, jz, rtol=1e-9)
    for a, b in zip(m, jm):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-15)
    # and the reverse: the port writes, the JAX package loads
    from_port = str(tmp_path / "port.npz")
    eng.save(from_port)
    jeng2 = jt_jax.Engine.load(from_port)
    assert jeng2.semiring.name == semiring
    jm2, jz2 = jeng2.query(ev)
    np.testing.assert_allclose(jz2, jz, rtol=1e-12)
    for a, b in zip(jm2, jm):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)
    masks = jt.batch_masks_sparse(eng.plan, [ev, {}], eng.semiring)
    post, logz = eng.posterior_batch(masks)
    jpost, jlogz = jeng2.posterior_batch(masks, mode="general")
    np.testing.assert_allclose(logz.numpy(), np.asarray(jlogz), rtol=1e-9)
    for a, b in zip(post, jpost):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)


def test_bfloat16_engine_saves_the_host_potentials(tmp_path):
    """A bfloat16 engine checkpoints the float64 host potentials, not its
    rounded storage copy; loaded in float64 it equals a float64 engine."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=4)
    bf = engine(factors, sizes, values, dtype=torch.bfloat16)
    bf.posterior_batch(jt.batch_masks_sparse(bf.plan, [{"g0_0": 1}]))
    assert bf._pots_prog[0].dtype == torch.bfloat16
    p = str(tmp_path / "bf16.npz")
    bf.save(p)
    with np.load(p) as d:
        assert d["pot_0"].dtype == np.float64
    wide = jt.Engine.load(p, device="cpu", dtype=torch.float64)
    want = engine(factors, sizes, values)
    for a, b in zip(wide._pots, want._pots):
        assert torch.equal(a, b)
    again = jt.Engine.load(p, device="cpu", dtype=torch.bfloat16)
    assert again.storage_dtype() == torch.bfloat16


def test_load_defaults_to_the_card(monkeypatch):
    """Like every entry point: no ``device=`` means CUDA device 0, and
    raises where there is none, before the file is touched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        jt.Engine.load("no_such_file.npz")


def test_describe(tmp_path, monkeypatch):
    from junctiontree_tpu_torch.config import DEFAULT
    from junctiontree_tpu_torch.ops import autotune

    # an empty decision table: no routed contraction was measured
    monkeypatch.setattr(DEFAULT, "autotune_cache_dir", str(tmp_path))
    monkeypatch.setattr(autotune, "_CACHE", None)
    TIMERS.reset()
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=0)
    eng = engine(factors, sizes, values)
    eng.posterior_batch({})
    eng.entropy_batch({})
    eng.map_assignment()
    d = eng.describe()
    jd = jt_jax.create_junction_tree(factors, sizes).engine().set_potentials(
        values).describe()
    for key in ("num_vars", "num_cliques", "treewidth", "max_clique_states",
                "max_sep_states", "semiring", "potentials_set", "chain_layout"):
        assert d[key] == jd[key], key
    assert d["device"] == "cpu" and d["dtype"] == "float64"
    assert d["cached_programs"] == ["entropy_batch", "general"]
    assert eng._max_delegate().describe()["cached_programs"] == ["tree_map"]
    for key in ("compile.intern", "compile.triangulate", "compile.treebuild",
                "engine.evaluate"):
        assert d["process_phase_totals_s"][key] >= 0.0, key
    assert set(d["kernel_launches"]) == {
        "factored_masked_contract", "factored_masked_contract_bf16",
        "factored_masked_contract_backward", "big_clique_route_calls"}
    assert all(isinstance(n, int) and n >= 0
               for n in d["kernel_launches"].values())
    for key in ("cold_start_serving", "kernel_routing"):
        assert key not in d
    assert not jt.Engine(eng.plan, device="cpu").describe()["potentials_set"]


def test_unset_engine_raises_standard_error_on_all_paths(tmp_path):
    """Every query path of an engine without potentials raises the standard
    RuntimeError."""
    # chain-structured plan so map_assignment_batch takes the Viterbi path
    factors, sizes, _ = chain_bn_model(6)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine("max_product", device="cpu")
    prob = tree.engine(device="cpu")
    for call in (
        lambda: eng.query({}),
        lambda: eng.query_batch({}),
        lambda: eng.posterior_batch({}),
        lambda: eng.map_assignment({}),
        lambda: eng.map_assignment_batch({}),
        lambda: eng.top_k_assignments({}),
        lambda: eng.top_k_assignments_batch({}),
        lambda: eng.score_assignment({}),
        lambda: eng.save(str(tmp_path / "nope.npz")),
        # non-max engines delegate MAP through the sibling: same error
        lambda: prob.map_assignment_batch({}),
        lambda: prob.entropy(),
        lambda: prob.entropy_batch({}),
        lambda: prob.joint_marginal(["x0", "x3"]),
        lambda: prob.joint_marginal_batch(["x0", "x3"], {}),
        lambda: prob.incremental({}),
    ):
        with pytest.raises(RuntimeError, match="set_potentials"):
            call()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_feasible_batch_matches_jax_arithmetic(dtype):
    """The port reckons the rows eager torch keeps (``ROW_CLIQUES``, fitted
    on the card) and the standing potentials; from a measured step
    (``analysis=``) it extrapolates as the JAX package does, and halves the
    probe batch of a step already over budget exactly as JAX does.  The JAX
    package's ``live_messages`` reckoning is refused."""
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=0)
    eng = engine(factors, sizes, values, dtype=dtype)
    jeng = jt_jax.Engine(jt_jax.compile_plan(factors, sizes)).set_potentials(values)
    st = eng.plan.stats()
    item = 2 if dtype is torch.bfloat16 else 4
    seps = sum(int(np.prod([eng.plan.sizes[v] for v in s]))
               for s in eng.plan.tree.separators)
    for task in ("posterior", "map"):
        row = item * int(eng.ROW_CLIQUES[task] * st["max_clique_states"] + 2 * seps)
        b = ((1 << 24) - item * st["total_clique_states"]) // row
        assert eng.max_feasible_batch(1 << 24, task=task) == 1 << (b.bit_length() - 1)
        # analysis-based estimate: the measured batch plus the headroom's rows
        analysis = {"batch": 4, "temp_bytes": 123_456}
        b = 4 + ((1 << 30) - 123_456) // row
        assert eng.max_feasible_batch(1 << 30, analysis=analysis, task=task) \
            == 1 << (b.bit_length() - 1)
    # a budget below the standing potentials still answers 1
    assert eng.max_feasible_batch(budget_bytes=16) == 1
    # a step already over budget halves the probe batch, as in JAX
    for batch, temp, budget in ((8, 2 << 30, 1 << 30), (64, 1 << 20, 1 << 19),
                                (1, 1 << 30, 1 << 20), (48, 9 << 30, 8 << 30)):
        over = {"batch": batch, "temp_bytes": temp}
        assert eng.max_feasible_batch(budget, analysis=over) == \
            jeng.max_feasible_batch(budget, analysis=over), over
    with pytest.raises(ValueError, match="live_messages"):
        eng.max_feasible_batch(1 << 20, live_messages=4)
