"""The port's joint marginals over arbitrary variable sets (``joint.py``,
``Engine.joint_marginal(_batch)``, ``mutual_information``) against the JAX
package on the same models and evidence, and against the brute-force joint.

Both packages run in float64 on the CPU.  Tolerances: tables, Z and mutual
information rtol 1e-9 (atol 1e-12) between the packages, atol 1e-6 / rtol
1e-5 against the brute force (as ``tests/test_joint.py``).  The route test
lowers the big-clique threshold of both packages so that the Steiner
elimination goes through the factored big-clique contraction (the JAX
package runs its Pallas kernel in interpret mode; the port its plain
version on the CPU)."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu.joint as jax_joint
import junctiontree_tpu.ops.pallas_contract as jax_pc
import junctiontree_tpu_torch as jt
from junctiontree_tpu.config import DEFAULT as JAX_DEFAULT
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.models import chain_bn_model
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS

from .util import brute_force_marginals, grid_mrf, random_factor_graph, random_values

RTOL, ATOL = 1e-9, 1e-12


def engines(factors, sizes, values, semiring=jt.SUM_PRODUCT):
    eng = jt.Engine(
        jt.compile_plan(factors, sizes), semiring, device="cpu",
        dtype=torch.float64,
    ).set_potentials(values)
    ref = jt_jax.Engine(
        jt_jax.compile_plan(factors, sizes), jt_jax.SEMIRINGS[semiring.name]
    ).set_potentials(values)
    return eng, ref


def check(factors, sizes, values, qvars, evidence=None,
          semiring=jt.SUM_PRODUCT, atol=1e-6):
    eng, ref = engines(factors, sizes, values, semiring)
    got, pz = eng.joint_marginal(qvars, evidence)
    want = brute_force_marginals(factors, sizes, values, [qvars], evidence)[0]
    z = want.sum()
    np.testing.assert_allclose(got, want / z, atol=atol)
    np.testing.assert_allclose(pz, z, rtol=1e-5)
    jgot, jpz = ref.joint_marginal(qvars, evidence)
    assert got.dtype == np.float64 and got.shape == jgot.shape
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pz, jpz, rtol=RTOL)
    # unnormalized tables agree too
    raw, _ = eng.joint_marginal(qvars, evidence, normalize=False)
    jraw, _ = ref.joint_marginal(qvars, evidence, normalize=False)
    np.testing.assert_allclose(raw, jraw, rtol=RTOL, atol=ATOL)
    return eng


def semiring_masks(eng, m):
    if not eng.semiring.is_log:
        return m
    with np.errstate(divide="ignore"):
        return np.log(m)


@pytest.mark.parametrize("semiring", [jt.SUM_PRODUCT, jt.LOG_SUM_EXP])
def test_within_clique_pair(semiring):
    factors = [["a", "b", "c"]]
    sizes = {"a": 2, "b": 3, "c": 2}
    values = random_values(factors, sizes, seed=0)
    check(factors, sizes, values, ["a", "c"], semiring=semiring)


@pytest.mark.parametrize("semiring", [jt.SUM_PRODUCT, jt.LOG_SUM_EXP])
def test_cross_clique_far_pair(semiring):
    """Opposite grid corners: the Steiner path crosses many cliques, and
    the elimination scope must stay |sep|+|Q|, not the union."""
    factors, sizes = grid_mrf(4, 4)
    values = random_values(factors, sizes, seed=1)
    check(factors, sizes, values, ["g0_0", "g3_3"], semiring=semiring)


def test_triple_across_cliques_with_evidence():
    factors, sizes = grid_mrf(3, 4)
    values = random_values(factors, sizes, seed=2)
    check(factors, sizes, values, ["g0_0", "g1_2", "g2_3"], evidence={"g2_0": 1})


def test_output_axis_order_matches_request():
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 3, "c": 4}
    values = random_values(factors, sizes, seed=3)
    eng = check(factors, sizes, values, ["c", "a"])
    j_ca, _ = eng.joint_marginal(["c", "a"])
    j_ac, _ = eng.joint_marginal(["a", "c"])
    assert j_ca.shape == (4, 2) and j_ac.shape == (2, 4)
    np.testing.assert_allclose(j_ca, j_ac.T, atol=1e-12)


def test_forest_components_independent():
    """Variables in DIFFERENT components: the joint factorizes (the empty
    separator join carries through the division exactly)."""
    factors = [["a", "b"], ["x", "y"]]
    sizes = {"a": 2, "b": 2, "x": 3, "y": 2}
    values = random_values(factors, sizes, seed=4)
    eng = check(factors, sizes, values, ["a", "x"])
    j, _ = eng.joint_marginal(["a", "x"])
    np.testing.assert_allclose(j, np.outer(j.sum(axis=1), j.sum(axis=0)), atol=1e-9)


def test_single_variable_equals_posterior():
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=5)
    eng, _ = engines(factors, sizes, values)
    j, _ = eng.joint_marginal(["g1_1"], {"g0_0": 1})
    post, _ = eng.query({"g0_0": 1})
    np.testing.assert_allclose(j, post[eng.plan.table.id_of("g1_1")], atol=1e-9)


@pytest.mark.parametrize("semiring", [jt.SUM_PRODUCT, jt.LOG_SUM_EXP])
def test_structural_zeros_and_impossible_evidence(semiring):
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 2, "c": 2}
    values = random_values(factors, sizes, seed=6)
    values[0][:, 0] = 0.0  # b=0 impossible
    eng = check(factors, sizes, values, ["a", "c"], semiring=semiring)
    j, pz = eng.joint_marginal(["a", "c"], {"b": 0})  # impossible evidence
    assert pz == pytest.approx(0.0, abs=1e-12)
    assert (j == 0).all()


def test_errors():
    factors = [["a", "b"]]
    sizes = {"a": 2, "b": 2}
    values = random_values(factors, sizes, seed=7)
    eng, _ = engines(factors, sizes, values)
    with pytest.raises(ValueError, match="duplicates"):
        eng.joint_marginal(["a", "a"])
    with pytest.raises(ValueError, match="duplicates"):
        eng.joint_marginal_batch(["a", "a"], {})
    with pytest.raises(ValueError, match="state intermediate"):
        eng.joint_marginal(["a", "b"], max_states=1)
    with pytest.raises(ValueError, match="state intermediate"):
        eng.joint_marginal_batch(["a", "b"], {}, max_states=1)
    mx, _ = engines(factors, sizes, values, jt.MAX_PRODUCT)
    with pytest.raises(ValueError, match="probability semiring"):
        mx.joint_marginal(["a", "b"])
    with pytest.raises(ValueError, match="probability semiring"):
        mx.joint_marginal_batch(["a", "b"], {})


def test_steiner_subtree_is_minimal_and_matches_jax():
    factors, sizes = grid_mrf(4, 4)
    plan = jt.compile_plan(factors, sizes)
    jplan = jt_jax.compile_plan(factors, sizes)
    q = [plan.table.id_of("g0_0")]
    nodes, root, children = jt.steiner_subtree(plan, q)
    assert nodes == {plan.var_to_clique[q[0]]}  # single-clique query
    # a pair's subtree is exactly the tree path between their cliques
    q2 = [plan.table.id_of("g0_0"), plan.table.id_of("g3_3")]
    nodes2, root2, ch2 = jt.steiner_subtree(plan, q2)
    assert plan.var_to_clique[q2[0]] in nodes2
    assert plan.var_to_clique[q2[1]] in nodes2
    for c in nodes2:
        deg = len(ch2[c]) + (1 if plan.tree.parent[c] in nodes2 else 0)
        assert deg <= 2
    assert (nodes2, root2, ch2) == jax_joint.steiner_subtree(jplan, q2)


def test_mutual_information():
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 3, "c": 2}
    values = random_values(factors, sizes, seed=9)
    eng, ref = engines(factors, sizes, values)
    mi = eng.mutual_information("a", "c")
    j = brute_force_marginals(factors, sizes, values, [["a", "c"]])[0]
    p = j / j.sum()
    pa, pc = p.sum(1, keepdims=True), p.sum(0, keepdims=True)
    assert mi == pytest.approx(float(np.sum(p * np.log(p / (pa * pc)))), abs=1e-8)
    assert mi >= 0
    assert mi == pytest.approx(ref.mutual_information("a", "c"), rel=1e-9)
    assert eng.mutual_information("a", "c", {"b": 1}) == pytest.approx(
        ref.mutual_information("a", "c", {"b": 1}), abs=1e-12
    )
    # the helper takes tensors and unnormalized tables
    assert jt.mutual_information_from_joint(torch.as_tensor(j)) == \
        pytest.approx(jax_joint.mutual_information_from_joint(j), rel=1e-12)
    with pytest.raises(ValueError, match="does not normalize"):
        jt.mutual_information_from_joint(np.zeros((2, 2)))
    # independent components: MI == 0
    f2 = [["a", "b"], ["x", "y"]]
    s2 = {"a": 2, "b": 2, "x": 2, "y": 2}
    e2, _ = engines(f2, s2, random_values(f2, s2, seed=10))
    assert e2.mutual_information("a", "x") == pytest.approx(0.0, abs=1e-10)


@pytest.mark.parametrize("semiring", [jt.SUM_PRODUCT, jt.LOG_SUM_EXP])
def test_joint_marginal_batch(semiring):
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=11)
    eng, ref = engines(factors, sizes, values, semiring)
    m = np.ones((3, 2), dtype=np.float32)
    m[0] = [1.0, 0.0]
    m[1] = [0.0, 1.0]
    masks = {"g1_1": semiring_masks(eng, m)}
    for qvars in (["g0_0", "g2_2"], ["g2_2", "g1_1", "g0_1"]):
        tables, zs = eng.joint_marginal_batch(qvars, masks)
        assert tables.dtype == zs.dtype == torch.float64
        assert tuple(tables.shape) == (3,) + (2,) * len(qvars)
        jt_tables, jzs = ref.joint_marginal_batch(qvars, masks)
        np.testing.assert_allclose(tables.numpy(), np.asarray(jt_tables),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(zs.numpy(), np.asarray(jzs), rtol=RTOL)
        for b, ev in enumerate([{"g1_1": 0}, {"g1_1": 1}, None]):
            want = brute_force_marginals(factors, sizes, values, [qvars], ev)[0]
            np.testing.assert_allclose(tables[b].numpy(), want / want.sum(), atol=1e-5)
            assert float(zs[b]) == pytest.approx(want.sum(), rel=1e-5)
            one, z1 = eng.joint_marginal(qvars, ev)
            np.testing.assert_allclose(tables[b].numpy(), one, rtol=1e-9, atol=1e-12)


def test_joint_marginal_batch_full_mask_list():
    factors, sizes = grid_mrf(2, 3)
    values = random_values(factors, sizes, seed=13)
    eng, ref = engines(factors, sizes, values)
    rng = np.random.default_rng(0)
    full = [(rng.random((4, s)) > 0.3).astype(np.float64) + 1e-3
            for s in eng.plan.sizes]
    tables, zs = eng.joint_marginal_batch(["g0_0", "g1_2"], full)
    jtab, jzs = ref.joint_marginal_batch(["g0_0", "g1_2"], full)
    np.testing.assert_allclose(tables.numpy(), np.asarray(jtab), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(zs.numpy(), np.asarray(jzs), rtol=RTOL)


def test_joint_marginal_deep_underflow_normalizes():
    """On the log engine, a model whose unnormalized joint mass sits below
    exp(-745) must still return a finite normalized table."""
    n = 40
    factors = [[f"x{i}", f"x{i+1}"] for i in range(n)]
    sizes = {f"x{i}": 2 for i in range(n + 1)}
    rng = np.random.default_rng(7)
    # each factor ~1e-30: joint entries ~1e-1200, far below float64 range
    values = [(1e-30 * (0.5 + rng.random((2, 2)))) for _ in factors]
    eng, ref = engines(factors, sizes, values, jt.LOG_SUM_EXP)
    j, _ = eng.joint_marginal(["x0", f"x{n}"])
    assert np.isfinite(j).all() and j.sum() == pytest.approx(1.0, rel=1e-9)
    assert j.max() > 0.1  # a real distribution, not a zero table
    np.testing.assert_allclose(
        j, ref.joint_marginal(["x0", f"x{n}"])[0], rtol=RTOL, atol=ATOL
    )
    scaled = [v * 1e30 for v in values]
    want = brute_force_marginals(factors, sizes, scaled, [["x0", f"x{n}"]])[0]
    np.testing.assert_allclose(j, want / want.sum(), atol=1e-9)


@pytest.mark.parametrize("semiring", [jt.SUM_PRODUCT, jt.LOG_SUM_EXP])
def test_joint_marginal_batch_impossible_element(semiring):
    """A batch element with impossible evidence yields an all-zero table
    and Z = 0, never NaN."""
    factors = [["a", "b"], ["b", "c"]]
    sizes = {"a": 2, "b": 3, "c": 2}
    values = random_values(factors, sizes, seed=12)
    values[0][:, 0] = 0.0  # b=0 structurally impossible
    eng, ref = engines(factors, sizes, values, semiring)
    m = np.ones((2, 3), dtype=np.float32)
    m[0] = [1.0, 0.0, 0.0]  # impossible
    masks = {"b": semiring_masks(eng, m)}
    tables, zs = eng.joint_marginal_batch(["a", "c"], masks)
    tables, zs = tables.numpy(), zs.numpy()
    assert not np.isnan(tables).any() and not np.isnan(zs).any()
    assert (tables[0] == 0).all() and zs[0] == 0.0
    want = brute_force_marginals(factors, sizes, values, [["a", "c"]])[0]
    np.testing.assert_allclose(tables[1], want / want.sum(), atol=1e-5)
    jtab, jzs = ref.joint_marginal_batch(["a", "c"], masks)
    np.testing.assert_allclose(tables, np.asarray(jtab), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(zs, np.asarray(jzs), rtol=RTOL, atol=ATOL)


def test_long_chain_query_no_recursion_limit():
    """A joint across a 1500-step chain walks a 1500-clique Steiner path:
    the post-order must be iterative (Python's recursion limit is 1000)."""
    factors, sizes, values = chain_bn_model(1500, seed=0)
    eng, _ = engines(factors, sizes, values)
    names = list(sizes)
    j, _ = eng.joint_marginal([names[0], names[-1]])
    assert j.shape == (2, 2)
    np.testing.assert_allclose(j.sum(), 1.0, rtol=1e-9)
    post, _ = eng.query()
    np.testing.assert_allclose(
        j.sum(axis=1), post[eng.plan.table.id_of(names[0])], atol=1e-9
    )


def _hub_model():
    """A 10-variable dense hub (2^10 states) with three two-variable tails
    and a unary on every hub variable."""
    rng = np.random.default_rng(6)
    hub = [f"h{i}" for i in range(10)]
    factors = [hub] + [[h] for h in hub] + [[hub[i], f"t{i}"] for i in range(3)]
    sizes = {**{h: 2 for h in hub}, **{f"t{i}": 2 for i in range(3)}}
    values = [rng.random(tuple(sizes[v] for v in f)) + 0.1 for f in factors]
    return factors, sizes, values


@pytest.mark.parametrize("qvars", [["h0", "h8"], ["h8", "h1", "h7"], ["h3", "t1"]])
def test_joint_marginal_batch_takes_the_big_clique_route(monkeypatch, qvars):
    """Thresholds lowered to 2^8: the elimination of the hub (output scope
    inside the clique: C = 4 and 8; with a tail variable, the tail's
    message enters the hub as an operand) goes through the factored
    big-clique contraction in both packages, float32; rtol 1e-4 / atol 1e-6
    between them and against the port's float64 run without the route."""
    factors, sizes, values = _hub_model()
    rng = np.random.default_rng(2)
    masks = {}
    for v in ("t0", "t2", "h4", "h5", "h6", "h9"):
        m = np.zeros((6, 2), dtype=np.float32)
        m[np.arange(6), rng.integers(0, 2, 6)] = 1.0
        masks[v] = m
    masks["h5"][2] = 0.0  # an impossible row
    plain, _ = engines(factors, sizes, values)
    before = TIMERS.counters()["big_clique_sep_message.calls"]
    want_t, want_z = plain.joint_marginal_batch(qvars, masks)
    # 2^10 < 2^17
    assert TIMERS.counters()["big_clique_sep_message.calls"] == before

    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    monkeypatch.setattr(JAX_DEFAULT, "pallas_min_states", 1 << 8)
    eng = jt.Engine(
        jt.compile_plan(factors, sizes), device="cpu", dtype=torch.float32
    ).set_potentials(values)
    got_t, got_z = eng.joint_marginal_batch(qvars, masks)
    assert TIMERS.counters()["big_clique_sep_message.calls"] > before
    assert (got_t[2] == 0).all() and got_z[2] == 0
    np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), rtol=1e-4, atol=1e-6)
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
        ref_t, ref_z = ref.joint_marginal_batch(qvars, masks)
    finally:
        jax_pc.set_pallas_mode("auto")
    assert jax_kernel_calls and all(jax_kernel_calls)
    rows = [0, 1, 3, 4, 5]  # the JAX f32 CPU run may flush the floor on row 2
    np.testing.assert_allclose(got_t.numpy()[rows], np.asarray(ref_t)[rows],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_z.numpy()[rows], np.asarray(ref_z)[rows], rtol=1e-4)
