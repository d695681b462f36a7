"""The Ising spin glass of the UAI "Grids" class on the port's general
program: the generator, the program against the lattice's transfer sweep
(``portbench/lattice_reference.py``) and against brute force, and the
compile layer's bandwidth order.

Tolerances.  float64: 1e-10, rounding of a few hundred float64 operations.
float32: posteriors 1e-5 (the unit roundoff 6e-8 times the ~100 rounded
products and sums on a message's path across a 5 x 5 lattice's tree) and
logZ 1e-5 of |logZ| (each of the ~30 collect offsets is the log of a float32
maximum, and their sum carries their rounding, relative to logZ's size).
"""

import hashlib
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.models import grid_mrf_model, ising_grid_model
from junctiontree_tpu_torch.utils.timing import TIMERS

from portbench.lattice_reference import reference
from .util import brute_force_marginals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (1e-5, 1e-5)}


def _masks(sizes, B, seed, every=4):
    """Evidence on every ``every``-th site, states from ``seed``; row 0
    impossible."""
    rng = np.random.default_rng(seed)
    masks = {}
    for v in list(sizes)[::every]:
        m = np.zeros((B, 2), dtype=np.float32)
        m[np.arange(B), rng.integers(2, size=B)] = 1.0
        masks[v] = m
    masks[next(iter(masks))][0] = 0.0
    return masks


def _brute(factors, sizes, values, masks, rows, labels):
    """Posteriors {label: [rows, 2]} of ``labels`` and logZ [rows] by
    enumeration (``tests/util.brute_force_marginals``)."""
    post = {v: np.zeros((rows, 2)) for v in labels}
    logz = np.zeros(rows)
    for r in range(rows):
        evidence = {v: int(m[r].argmax()) for v, m in masks.items()
                    if m[r].any()}
        if len(evidence) < len(masks):
            logz[r] = -np.inf
            continue
        out = brute_force_marginals(factors, sizes, values,
                                    [[v] for v in labels] + [[]], evidence)
        z = float(out[-1])
        logz[r] = math.log(z)
        for v, m in zip(labels, out):
            post[v][r] = m / z
    return post, logz


@pytest.fixture(scope="module", params=[(4, 4), (5, 5)], ids=str)
def lattice(request):
    rows, cols = request.param
    factors, sizes, values = ising_grid_model(rows, cols, 10.0, seed=rows)
    masks = _masks(sizes, 4, seed=cols)
    want = reference(factors, sizes, values, masks, "cpu")
    # enumeration of every site on 4 x 4; of the diagonal's on 5 x 5, where
    # each marginal is a contraction of 2^25 states
    labels = [v for v in sizes if rows == 4 or v[1:].split("_")[0]
              == v.split("_")[1]]
    brute = _brute(factors, sizes, values, masks, 4, labels)
    free = reference(factors, sizes, values,
                     {v: np.ones((1, 2), np.float32) for v in sizes}, "cpu")
    return factors, sizes, values, masks, want, brute, free


def test_the_generator_follows_its_recipe():
    factors, sizes, values = ising_grid_model(3, 4, 10.0, field_scale=1.0,
                                              seed=7)
    assert list(sizes) == [f"s{r}_{c}" for r in range(3) for c in range(4)]
    assert set(sizes.values()) == {2}
    assert len(factors) == 12 + 3 * 3 + 2 * 4
    rng = np.random.default_rng(7)
    fields = rng.uniform(-1.0, 1.0, size=12)
    couplings = rng.uniform(-10.0, 10.0, size=17)
    assert factors[12] == ["s0_0", "s0_1"] and factors[13] == ["s0_0", "s1_0"]
    np.testing.assert_array_equal(values[0], np.exp([-fields[0], fields[0]]))
    t = couplings[1]
    np.testing.assert_array_equal(values[13],
                                  np.exp([[t, -t], [-t, t]]))


@pytest.mark.parametrize("shape", [(4, 4), (20, 20), (3, 7)])
@pytest.mark.parametrize("seed", [0, 5])
def test_the_portbench_copy_is_the_generator(shape, seed):
    from portbench.models import ising_grid

    cfg = {"rows": shape[0], "cols": shape[1], "coupling_scale": 10.0,
           "field_scale": 1.0, "model_seed": seed}
    f1, s1, v1 = ising_grid.build(cfg)
    f2, s2, v2 = ising_grid_model(shape[0], shape[1], 10.0, 1.0, seed)
    assert f1 == f2 and s1 == s2
    for a, b in zip(v1, v2):
        np.testing.assert_array_equal(a, b)


def test_the_lattice_reference_is_brute_force(lattice):
    _, _, _, masks, want, brute, _ = lattice
    for v, p in brute[0].items():
        np.testing.assert_allclose(want["post"][v], p, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.isneginf(want["logz"]),
                                  np.isneginf(brute[1]))
    ok = np.isfinite(brute[1])
    np.testing.assert_allclose(want["logz"][ok], brute[1][ok], rtol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("evidence", [True, False], ids=["evidence", "none"])
def test_the_program_matches_the_reference_and_brute_force(lattice, dtype,
                                                          evidence):
    factors, sizes, values, masks, want, brute, free = lattice
    eng = jt.create_junction_tree(factors, sizes).engine(
        device="cpu", dtype=dtype).set_potentials(values)
    assert eng._route("auto") == "general"
    post, logz = eng.posterior_batch(masks if evidence else {})
    label = eng.plan.table.label_of
    got = {label(v): p.double().numpy() for v, p in enumerate(post)}
    logz = logz.double().numpy()
    atol, rtol_z = TOL[dtype]
    for ans in ([want, brute] if evidence else [free]):
        ans_post, ans_logz = (ans["post"], ans["logz"]) if isinstance(
            ans, dict) else ans
        for v, p in ans_post.items():
            np.testing.assert_allclose(got[v], np.broadcast_to(
                p, got[v].shape), rtol=0, atol=atol)
        ok = np.isfinite(ans_logz)
        np.testing.assert_allclose(logz[ok], ans_logz[ok], rtol=rtol_z,
                                   atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_an_impossible_row_gives_zeros_and_minus_infinity(lattice, dtype):
    factors, sizes, values, masks, _, _, _ = lattice
    eng = jt.create_junction_tree(factors, sizes).engine(
        device="cpu", dtype=dtype).set_potentials(values)
    post, logz = eng.posterior_batch(masks)
    assert torch.isneginf(logz[0]) and torch.isfinite(logz[1:]).all()
    for p in post:
        assert not torch.isnan(p).any()
        assert (p[0] == 0).all()
        torch.testing.assert_close(p[1:].sum(1), torch.ones_like(p[1:, 0]))


def test_the_program_drops_each_message_after_its_last_step(lattice,
                                                           monkeypatch):
    """The serving program keeps a message only until the last step that
    reads it: the same bits as the schedule that keeps every message, fewer
    messages alive at once, and only the marginals and Z left."""
    from junctiontree_tpu_torch.executor import BatchedProgramBuilder

    factors, sizes, values, masks, _, _, _ = lattice
    eng = jt.create_junction_tree(factors, sizes).engine(
        device="cpu", dtype=torch.float64).set_potentials(values)
    ids, placed = eng._masks_to_program_args(masks)
    builder = BatchedProgramBuilder(eng.plan, jt.SUM_PRODUCT, list(ids),
                                    rescale=True, headroom=True)
    live = []
    inner = BatchedProgramBuilder._run_step

    def spy(self, s, st, *args):
        inner(self, s, st, *args)
        live.append(sum(k[0] in ("up", "down", "bel") for k in st))

    monkeypatch.setattr(BatchedProgramBuilder, "_run_step", spy)
    kept = builder.run(eng._program_pots(), placed,
                       kinds=("up", "down", "marg", "z"))
    most_kept, live[:] = max(live), []
    dropped = builder.run(eng._program_pots(), placed)
    assert max(live) < most_kept
    assert {k[0] for k in dropped} == {"marg", "z", "logoff"}
    for k, t in dropped.items():
        assert torch.equal(t, kept[k])


def test_float64_beliefs_below_float32s_range_come_out_normalized():
    """Couplings of scale 100 on a 4 x 4 lattice: where the collect and the
    distribute message disagree, a belief's mass falls below 1e-38, the
    float32 floor, which float64 rescaling and normalizing no longer
    take."""
    factors, sizes, values = ising_grid_model(4, 4, 100.0, seed=1)
    masks = _masks(sizes, 6, seed=2, every=3)
    want = reference(factors, sizes, values, masks, "cpu")
    tree = jt.create_junction_tree(factors, sizes)
    post, logz = tree.engine(device="cpu", dtype=torch.float64) \
        .set_potentials(values).posterior_batch(masks)
    label = tree.plan.table.label_of
    for v, p in enumerate(post):
        np.testing.assert_allclose(p.numpy(), want["post"][label(v)],
                                   rtol=0, atol=1e-10)
    ok = np.isfinite(want["logz"])
    assert np.array_equal(ok, torch.isfinite(logz).numpy())
    np.testing.assert_allclose(logz.numpy()[ok], want["logz"][ok], rtol=1e-10)


def test_float32_beliefs_below_float32s_range_come_out_normalized():
    """Couplings of scale 20 on a 6 x 6 lattice, a third of the spins
    observed: where the evidence pulls the collect and the distribute
    message apart, their product at a clique falls below float32's least
    normal value when each is divided by its own maximum.  The distribute
    pass scales each message so that the clique's belief sums to one."""
    factors, sizes, values = ising_grid_model(6, 6, 20.0, seed=1)
    masks = _masks(sizes, 8, seed=1, every=3)
    masks[next(iter(masks))][0] = 1.0 - masks[next(iter(masks))][0]
    want = reference(factors, sizes, values, masks, "cpu")
    tree = jt.create_junction_tree(factors, sizes)
    post, logz = tree.engine(device="cpu", dtype=torch.float32) \
        .set_potentials(values).posterior_batch(masks)
    label = tree.plan.table.label_of
    for v, p in enumerate(post):
        np.testing.assert_allclose(p.double().numpy(), want["post"][label(v)],
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(logz.double().numpy(), want["logz"],
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_every_belief_the_marginals_read_sums_to_at_least_one(lattice, dtype):
    """Each batched distribute message is scaled up, never down, toward a
    belief of sum one at its clique (float32 and float64 have the headroom
    for it on these lattices): the marginals of the variables such a clique
    homes, as the serving program hands them to the normalizer, sum to one
    or more, finite, and to zero in the impossible row."""
    from junctiontree_tpu_torch.executor import BatchedProgramBuilder

    factors, sizes, values, masks, _, _, _ = lattice
    eng = jt.create_junction_tree(factors, sizes).engine(
        device="cpu", dtype=dtype).set_potentials(values)
    ids, placed = eng._masks_to_program_args(masks)
    builder = BatchedProgramBuilder(eng.plan, jt.SUM_PRODUCT, list(ids),
                                    rescale=True, headroom=True)
    margs, _ = builder.full()(eng._program_pots(), placed)
    homes = [v for v in range(len(margs))
             if builder.down_b.get(eng.plan.var_to_clique[v], False)]
    assert len(homes) > len(margs) // 2
    for m in (margs[v] for v in homes):
        total = m.sum(-1).double()
        assert total[0] == 0
        assert torch.isfinite(total).all() and (total[1:] > 1 - 1e-5).all()


# -- the compile layer ----------------------------------------------------------

def _shuffled(factors, sizes, seed):
    """The same lattice under other labels, its factors in another order."""
    rng = np.random.default_rng(seed)
    names = {v: f"v{i}" for v, i in zip(sizes, rng.permutation(len(sizes)))}
    order = rng.permutation(len(factors))
    return ([[names[v] for v in factors[i]] for i in order],
            {names[v]: k for v, k in sizes.items()})


def _digest(plan):
    return hashlib.sha256(plan.to_json().encode()).hexdigest()


@pytest.fixture(scope="module")
def grid20():
    factors, sizes, _ = ising_grid_model(20, 20, 10.0)
    before = TIMERS.counters()["compile.escalations"]
    plan = jt.compile_plan(factors, sizes)
    return factors, sizes, plan, TIMERS.counters()["compile.escalations"] \
        - before


def test_auto_takes_the_bandwidth_order_on_the_20x20_lattice(grid20):
    """min-fill lands 2^28 states; the bandwidth sweep 2^21 (the optimal
    width 20), and the escalation keeps it."""
    _, _, plan, escalations = grid20
    st = plan.stats()
    assert st["max_clique_states"] <= 1 << 21
    assert st["treewidth"] == 20 and st["order"] == "bandwidth"
    assert escalations == 1


def test_the_20x20_plan_is_the_same_in_another_process(grid20):
    _, _, plan, _ = grid20
    code = ("import hashlib, sys; sys.modules['jax'] = None\n"
            "import junctiontree_tpu_torch as jt\n"
            "from junctiontree_tpu_torch.models import ising_grid_model\n"
            "f, s, _ = ising_grid_model(20, 20, 10.0)\n"
            "print(hashlib.sha256(jt.compile_plan(f, s).to_json().encode())"
            ".hexdigest())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True)
    assert out.stdout.split()[-1] == _digest(plan)


def test_the_20x20_bound_holds_under_another_labelling(grid20):
    factors, sizes, _, _ = grid20
    plan = jt.compile_plan(*_shuffled(factors, sizes, 11))
    assert plan.stats()["max_clique_states"] <= 1 << 21


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_bandwidth_order_is_as_wide_as_the_lattice_under_any_labels(
        seed):
    """The optimal width on a square lattice, at most one more on a
    rectangle, whatever the labels."""
    from junctiontree_tpu_torch.labels import intern_factors
    from junctiontree_tpu_torch.triangulate import bandwidth_triangulation

    for rows, cols in ((20, 20), (9, 9), (12, 16), (16, 12)):
        f, s, _ = ising_grid_model(rows, cols, 10.0)
        _, fi, si = intern_factors(*_shuffled(f, s, seed))
        tri = bandwidth_triangulation(fi, si)
        width = min(rows, cols)
        if rows == cols:
            assert tri.treewidth == width
        else:
            assert width <= tri.treewidth <= width + 1


def _largest_and_total(tri, sizes):
    from junctiontree_tpu_torch.triangulate import total_states

    return (max(math.prod(sizes[v] for v in c) for c in tri.maxcliques),
            total_states(tri, sizes))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_an_escalating_model_keeps_a_plan_no_worse_than_before(seed):
    """On a hailfinder-class network min-fill escalates: the portfolio and
    annealing run as they did before the bandwidth order was a candidate,
    and the plan kept is theirs unless the bandwidth order beats it (a
    smaller largest clique, then fewer states in all)."""
    from junctiontree_tpu_torch.labels import intern_factors
    from junctiontree_tpu_torch.models import hailfinder_like
    from junctiontree_tpu_torch.triangulate import (
        anneal_triangulation, bandwidth_triangulation,
        min_fill_triangulation, portfolio_triangulation)

    factors, sizes, _ = hailfinder_like(seed)
    _, fi, si = intern_factors(factors, sizes)
    before = min_fill_triangulation(fi, si)
    assert _largest_and_total(before, si)[0] > DEFAULT.escalate_min_states
    for make in (lambda: portfolio_triangulation(fi, si, random_restarts=16),
                 lambda: anneal_triangulation(fi, si, steps=2000)):
        if _largest_and_total(before, si)[0] <= DEFAULT.escalate_min_states:
            break
        tri = make()
        if _largest_and_total(tri, si) < _largest_and_total(before, si):
            before = tri
    plan = jt.compile_plan(factors, sizes)
    got = _largest_and_total(plan.tri, si)
    assert got <= _largest_and_total(before, si)
    if plan.stats()["order"] == "bandwidth":
        assert got < _largest_and_total(before, si)
        assert plan.tri.maxcliques == bandwidth_triangulation(
            fi, si).maxcliques
    else:
        assert plan.tri.maxcliques == before.maxcliques


def _hmm_structure(K=500, M=256):
    """The Li-Stephens configuration's factor graph (no values)."""
    x = [f"x{m}" for m in range(M)]
    y = [f"y{m}" for m in range(M)]
    factors = [[x[0]]]
    for m in range(M):
        if m > 0:
            factors.append([x[m - 1], x[m]])
        factors.append([x[m], y[m]])
    return factors, {**{v: K for v in x}, **{v: 2 for v in y}}


def _bigclique18():
    names = [f"v{i}" for i in range(18)]
    return [names[:]] + [[v] for v in names], {v: 2 for v in names}


@pytest.mark.parametrize("name", ["bigclique18", "hmm500", "grid8x8",
                                  "ising5x5", "ising12x12"])
def test_plans_that_do_not_escalate_are_unchanged(name):
    """A model whose min-fill plan stays under ``escalate_min_states`` never
    escalates: its plan is the JAX package's, string for string."""
    if name == "bigclique18":
        factors, sizes = _bigclique18()
    elif name == "hmm500":
        factors, sizes = _hmm_structure()
    elif name == "grid8x8":
        factors, sizes, _ = grid_mrf_model(8, 8)
    else:
        n = int(name[5:].split("x")[0])
        factors, sizes, _ = ising_grid_model(n, n, 10.0)
    before = TIMERS.counters()["compile.escalations"]
    plan = jt.compile_plan(factors, sizes)
    assert TIMERS.counters()["compile.escalations"] == before
    assert plan.stats()["order"] == "min_fill"
    assert plan.stats()["max_clique_states"] <= DEFAULT.escalate_min_states
    assert plan.to_json() == jt_jax.compile_plan(factors, sizes).to_json()
