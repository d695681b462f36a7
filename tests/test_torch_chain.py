"""Chain (forward-backward) serving of the port: detection, the chain
program against the JAX package's scan program, the general program and the
brute-force oracle, and the stacked transitions' lifetime."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.scan_executor import ChainLayout as JaxChainLayout
from junctiontree_tpu.scan_executor import chain_posterior_program as jax_chain_program
from junctiontree_tpu_torch.models import chain_bn_model, grid_mrf_model
from junctiontree_tpu_torch.scan_executor import (
    ChainLayout,
    StackedPosteriors,
    chain_posterior_program,
    stack_chain_potentials,
)

from .util import brute_force_marginals, chain_bn


def test_detect_chain_matches_jax():
    plan = jt.compile_plan(*chain_bn(10))
    layout = ChainLayout.detect(plan)
    assert layout is not None
    assert len(layout.clique_order) == 9
    assert len(layout.var_order) == 10
    assert layout.card == 2
    jlayout = JaxChainLayout.detect(jt_jax.compile_plan(*chain_bn(10)))
    assert (layout.var_order, layout.clique_order, layout.transpose) == (
        jlayout.var_order, jlayout.clique_order, jlayout.transpose)


@pytest.mark.parametrize("case", ["card3", "grid", "star", "mixed", "single"])
def test_detect_rejects_non_chains(case):
    if case == "card3":
        assert ChainLayout.detect(jt.compile_plan(*chain_bn(10, card=3))) is not None
        return
    if case == "grid":
        factors, sizes, _ = grid_mrf_model(3, 3)
    elif case == "star":  # cliques are 2-var but the tree is a star
        factors = [["h", f"l{i}"] for i in range(4)]
        sizes = {"h": 2, **{f"l{i}": 2 for i in range(4)}}
    elif case == "mixed":  # mixed cardinalities on a chain
        factors, sizes = [["a", "b"], ["b", "c"]], {"a": 2, "b": 3, "c": 2}
    else:
        factors, sizes = [["a", "b"]], {"a": 2, "b": 2}
    assert ChainLayout.detect(jt.compile_plan(factors, sizes)) is None


def _chain_case(n, card, B=4):
    factors, sizes, values = chain_bn_model(n, card=card, seed=n)
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, B, [f"x{n//2}", f"x{n-1}"], seed=n)
    return factors, sizes, values, tree, evs


@pytest.mark.parametrize("n,card", [(5, 2), (20, 3), (40, 4)])
def test_chain_posterior_matches_jax_and_oracle(n, card):
    """Auto mode takes the chain program; float64 against the JAX engine's
    chain program (rtol 1e-9) and the brute-force oracle (rtol 1e-7; the
    n = 40 chain is too long to enumerate and is held to JAX only)."""
    factors, sizes, values, tree, evs = _chain_case(n, card)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    assert eng._route("auto") == "chain"
    masks = jt.batch_masks_sparse(tree.plan, evs)
    post, logz = eng.posterior_batch(masks)
    assert isinstance(post, StackedPosteriors) and len(post) == n
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    assert jeng._chain_layout() is not None
    jpost, jlogz = jeng.posterior_batch(masks)
    np.testing.assert_allclose(logz.numpy(), np.asarray(jlogz), rtol=1e-9)
    for v in range(n):
        np.testing.assert_allclose(
            post[v].numpy(), np.asarray(jpost[v]), rtol=1e-9, atol=1e-14)
    if n > 20:
        return
    var_list = list(sizes)
    for b in (0, 3):
        expect = brute_force_marginals(
            factors, sizes, values, [[v] for v in var_list], evidence=evs[b])
        np.testing.assert_allclose(
            float(logz[b]), np.log(expect[0].sum()), rtol=1e-7)
        for i, v in enumerate(var_list):
            np.testing.assert_allclose(
                post[tree.plan.table.id_of(v)][b].numpy(),
                expect[i] / expect[i].sum(), rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_chain_matches_general_with_impossible_row(dtype, rtol):
    """The chain program against ``mode="general"`` on a 200-variable chain;
    row 2 is impossible (zero posteriors, logZ = -inf, never NaN)."""
    factors, sizes, values, tree, evs = _chain_case(200, 3, B=5)
    eng = tree.engine(device="cpu", dtype=dtype).set_potentials(values)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    masks["x100"][2] = 0.0
    post, logz = eng.posterior_batch(masks)
    gpost, glogz = eng.posterior_batch(masks, mode="general")
    assert torch.isneginf(logz[2]) and torch.isneginf(glogz[2])
    rows = [0, 1, 3, 4]
    np.testing.assert_allclose(logz[rows], glogz[rows], rtol=rtol)
    assert not torch.isnan(post.stacked).any()
    assert (post.stacked[:, 2] == 0).all()
    for v in range(200):
        np.testing.assert_allclose(post[v], gpost[v], rtol=rtol, atol=1e-7)


def test_chain_program_matches_jax_program_on_dense_masks():
    """The program itself on one stacked [m+1, B, K] mask tensor against the
    JAX scan program on the same stack (float64, rtol 1e-10)."""
    factors, sizes, values, tree, _ = _chain_case(15, 3)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    layout = ChainLayout.detect(tree.plan)
    A = stack_chain_potentials(layout, eng._pots_np)
    assert A.shape == (14, 3, 3)
    np.testing.assert_array_equal(
        A, jt.chain_stack_from_numpy(tree.plan.to_json(), eng._pots_np))
    rng = np.random.default_rng(0)
    M = (rng.random((15, 6, 3)) < 0.7).astype(np.float64)
    post, logz = chain_posterior_program(tree.plan, layout)(
        torch.as_tensor(A), torch.as_tensor(M))
    jplan = jt_jax.compile_plan(factors, sizes)
    jpost, jlogz = jax_chain_program(jplan, JaxChainLayout.detect(jplan))(A, M)
    jlogz = np.asarray(jlogz)
    np.testing.assert_array_equal(np.isneginf(logz.numpy()), np.isneginf(jlogz))
    fin = np.isfinite(jlogz)
    np.testing.assert_allclose(logz.numpy()[fin], jlogz[fin], rtol=1e-10)
    np.testing.assert_allclose(post.numpy()[:, fin], np.asarray(jpost)[:, fin],
                               rtol=1e-10, atol=1e-15)


def test_chain_no_evidence():
    factors, sizes, values = chain_bn_model(12, seed=3)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    post, logz = eng.posterior_batch({})
    # proper BN: logZ == 0
    np.testing.assert_allclose(logz.numpy(), 0.0, atol=1e-12)
    expect = brute_force_marginals(factors, sizes, values, [[v] for v in sizes])
    for i, v in enumerate(sizes):
        np.testing.assert_allclose(
            post[tree.plan.table.id_of(v)][0].numpy(),
            expect[i] / expect[i].sum(), rtol=1e-9)


def test_chain_stack_is_rebuilt_after_set_potentials():
    """The stacked transitions are cached per ``set_potentials``; new
    potentials must not be served from the old stack."""
    factors, sizes, values = chain_bn_model(10, seed=1)
    _, _, other = chain_bn_model(10, seed=2)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    masks = jt.batch_masks_sparse(tree.plan, [{"x9": 1}])
    first, _ = eng.posterior_batch(masks)
    stack = eng._chain_A
    eng.posterior_batch(masks)
    assert eng._chain_A is stack
    second, _ = eng.set_potentials(other).posterior_batch(masks)
    assert eng._chain_A is not stack
    want, _ = eng.posterior_batch(masks, mode="general")
    assert not torch.allclose(first[0], second[0])
    np.testing.assert_allclose(second[0], want[0], rtol=1e-9)


@pytest.mark.parametrize("semiring", ["log_sum_exp", "max_product"])
def test_chain_log_engines_take_the_general_program(semiring):
    factors, sizes, values = chain_bn_model(8, seed=1)
    eng = jt.create_junction_tree(factors, sizes).engine(
        semiring, device="cpu").set_potentials(values)
    assert eng._route("auto") == "general"
    post, _ = eng.posterior_batch({})
    assert isinstance(post, list)
