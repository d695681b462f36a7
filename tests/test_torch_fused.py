"""Level-fused serving of the port: the grouped schedule against the JAX
package's, the fused program against the general program, the JAX fused
program and the oracle on many topologies, and the auto-mode rule."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.fused import build_fused_schedule as jax_build_fused_schedule
from junctiontree_tpu_torch.fused import FusedPosteriors, build_fused_schedule
from junctiontree_tpu_torch.models import grid_mrf_model, star_bn_model

from .util import (
    brute_force_marginals,
    chain_bn,
    grid_mrf,
    random_factor_graph,
    random_values,
)


def test_schedule_covers_all_cliques_and_matches_jax():
    plan = jt.compile_plan(*grid_mrf(4, 4))
    sched, sorted_children = build_fused_schedule(plan)
    seen = sorted(c for gs in sched.levels for g in gs for c in g.cliques)
    assert seen == list(range(plan.tri.num_cliques))
    # every var has a mask site inside its clique
    for v, (d, gi, slot, axis) in sched.mask_site.items():
        c = sched.levels[d][gi].cliques[slot]
        assert plan.clique_vars[c][axis] == v
    jsched, jchildren = jax_build_fused_schedule(jt_jax.compile_plan(*grid_mrf(4, 4)))
    assert sched.clique_pos == jsched.clique_pos
    assert sched.mask_site == jsched.mask_site
    assert sorted_children == jchildren
    assert [[(g.cliques, g.shape, g.parent_axes, g.child_axes) for g in gs]
            for gs in sched.levels] == [
        [(g.cliques, g.shape, g.parent_axes, g.child_axes) for g in gs]
        for gs in jsched.levels]


def test_schedule_groups_tied_structures():
    factors, sizes, _ = star_bn_model(16)
    sched, _ = build_fused_schedule(jt.compile_plan(factors, sizes))
    assert sum(len(gs) for gs in sched.levels) <= 3


def _diff_check(factors, sizes, values, observed, B=5, seed=0):
    """Fused against general (float64, rtol 1e-9), against the JAX package's
    fused program (rtol 1e-9), and row 0 against the oracle (rtol 1e-7);
    the last row is impossible evidence."""
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    evs = jt.random_evidence_batch(tree.plan, B, observed, seed=seed)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    masks[observed[0]][B - 1] = 0.0
    post_f, logz_f = eng.posterior_batch(masks, mode="fused")
    assert isinstance(post_f, FusedPosteriors)
    post_g, logz_g = eng.posterior_batch(masks, mode="general")
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    post_j, logz_j = jeng.posterior_batch(masks, mode="fused")
    assert torch.isneginf(logz_f[B - 1]) and torch.isneginf(logz_g[B - 1])
    rows = list(range(B - 1))
    np.testing.assert_allclose(logz_f[rows], logz_g[rows], rtol=1e-9)
    np.testing.assert_allclose(
        logz_f.numpy()[rows], np.asarray(logz_j)[rows], rtol=1e-9)
    for v in range(tree.plan.num_vars):
        assert not torch.isnan(post_f[v]).any() and (post_f[v][B - 1] == 0).all()
        np.testing.assert_allclose(post_f[v], post_g[v], rtol=1e-9, atol=1e-13)
        np.testing.assert_allclose(
            post_f[v].numpy()[rows], np.asarray(post_j[v])[rows],
            rtol=1e-9, atol=1e-13)
    var_list = list(sizes)
    expect = brute_force_marginals(
        factors, sizes, values, [[v] for v in var_list], evidence=evs[0])
    for i, v in enumerate(var_list):
        np.testing.assert_allclose(
            post_f[tree.plan.table.id_of(v)][0].numpy(),
            expect[i] / expect[i].sum(), rtol=1e-7, atol=1e-12)


def test_fused_matches_general_grid():
    factors, sizes = grid_mrf(4, 4)
    values = random_values(factors, sizes, seed=2)
    _diff_check(factors, sizes, values, ["g0_0", "g2_2", "g3_3"])


def test_fused_matches_general_mixed_cards():
    factors, sizes = grid_mrf(3, 4, card=3)
    values = random_values(factors, sizes, seed=3)
    _diff_check(factors, sizes, values, ["g0_1", "g2_3"])


def test_fused_star():
    factors, sizes, values = star_bn_model(10)
    _diff_check(factors, sizes, values, ["leaf0", "leaf7"])


@pytest.mark.parametrize("seed", range(6))
def test_fused_random_graphs(seed):
    factors, sizes = random_factor_graph(seed + 300, n_vars=9, n_factors=12)
    values = random_values(factors, sizes, seed=seed)
    _diff_check(factors, sizes, values, list(sizes)[:3], seed=seed)


def test_fused_chain_topology():
    """Chains normally route to the chain program; force the fused path."""
    factors, sizes = chain_bn(12, card=3)
    values = random_values(factors, sizes, seed=4)
    _diff_check(factors, sizes, values, ["x3", "x11"])


def test_fused_no_evidence():
    factors, sizes = grid_mrf(3, 3)
    values = random_values(factors, sizes, seed=5)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    post, logz = eng.posterior_batch_fused({})
    (z,) = brute_force_marginals(factors, sizes, values, [[]])
    np.testing.assert_allclose(float(logz[0]), np.log(z), rtol=1e-9)


def test_fused_float32_and_full_mask_list():
    """float32 engine, masks for every variable id as a list: within
    rtol 1e-4 / atol 1e-6 of the general program."""
    factors, sizes, values = grid_mrf_model(4, 4, seed=1)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float32).set_potentials(values)
    evs = jt.random_evidence_batch(tree.plan, 6, list(sizes)[::5], seed=2)
    masks = jt.batch_masks(tree.plan, evs)
    post_f, logz_f = eng.posterior_batch(masks, mode="fused")
    post_g, logz_g = eng.posterior_batch(masks, mode="general")
    np.testing.assert_allclose(logz_f, logz_g, rtol=1e-5)
    for v in range(tree.plan.num_vars):
        np.testing.assert_allclose(post_f[v], post_g[v], rtol=1e-4, atol=1e-6)


def test_fused_stack_is_rebuilt_after_set_potentials():
    factors, sizes, values = star_bn_model(10, seed=0)
    _, _, other = star_bn_model(10, seed=1)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    masks = jt.batch_masks_sparse(tree.plan, [{"leaf3": 1}])
    eng.posterior_batch(masks, mode="fused")
    stack, prog = eng._fused_stack, eng._programs[("fused", (4,))]
    eng.posterior_batch(masks, mode="fused")
    assert eng._fused_stack is stack
    post, _ = eng.set_potentials(other).posterior_batch(masks, mode="fused")
    assert eng._fused_stack is not stack
    # the program and its index tensors are per schedule, not per call
    assert eng._programs[("fused", (4,))] is prog
    want, _ = eng.posterior_batch(masks, mode="general")
    for v in range(tree.plan.num_vars):
        np.testing.assert_allclose(post[v], want[v], rtol=1e-9)
    stacks = jt.fused_stacks_from_numpy(tree.plan.to_json(), eng._pots_np)
    for level, got in zip(stacks, eng._fused_stack):
        for a, b in zip(level, got):
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("name", ["star40", "grid6x6", "star20", "chain40"])
def test_auto_routes_as_the_jax_engine_does(name):
    """star_bn_model(40): grouping fuses, auto takes the fused program; the
    irregular 6x6 grid stays on the general program; 21 cliques are too few;
    a chain takes the chain program."""
    if name.startswith("star"):
        factors, sizes, values = star_bn_model(int(name[4:]))
        label = "leaf0"
    elif name == "grid6x6":
        factors, sizes = grid_mrf(6, 6)
        values = random_values(factors, sizes, seed=6)
        label = "g0_0"
    else:
        factors, sizes = chain_bn(40)
        values = random_values(factors, sizes, seed=6)
        label = "x0"
    want = {"star40": "fused", "grid6x6": "general", "star20": "general",
            "chain40": "chain"}[name]
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    assert eng._route("auto") == want
    assert eng._route("general") == "general" and eng._route("fused") == "fused"
    evs = jt.random_evidence_batch(tree.plan, 3, [label], seed=1)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    post, logz = eng.posterior_batch(masks)
    assert isinstance(post, FusedPosteriors) == (want == "fused")
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    jpost, jlogz = jeng.posterior_batch(masks)
    jax_fused = any(k[0] == "fused" for k in jeng._batched_cache)
    assert jax_fused == (want == "fused")
    assert (jeng._chain_layout() is not None) == (want == "chain")
    np.testing.assert_allclose(logz.numpy(), np.asarray(jlogz), rtol=1e-9)
    for v in range(tree.plan.num_vars):
        np.testing.assert_allclose(
            post[v].numpy(), np.asarray(jpost[v]), rtol=1e-9, atol=1e-13)
