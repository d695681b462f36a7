"""The port's planned einsum against the JAX package's ``SUM_PRODUCT``, and
the greedy contraction planner's memory bound on a hailfinder-class model."""

import numpy as np
import pytest
import torch

import junctiontree_tpu_torch as jt
from junctiontree_tpu.ops.semirings import SUM_PRODUCT as JAX_SUM_PRODUCT
from junctiontree_tpu_torch import models
from junctiontree_tpu_torch.executor import batched_propagate_program
from junctiontree_tpu_torch.ops import semirings
from junctiontree_tpu_torch.ops.semirings import SUM_PRODUCT, plan_contraction


def _random_operands(seed, n_ops):
    """n_ops operands over up to 7 variables (plus the batch pseudo-variable
    -1 on some), sizes 2-3, and an output scope drawn from their union."""
    rng = np.random.default_rng(seed)
    extent = {v: int(rng.integers(2, 4)) for v in range(7)}
    extent[-1] = 3
    ovs = []
    for _ in range(n_ops):
        k = int(rng.integers(1, 4))
        vs = [int(x) for x in rng.choice(7, size=k, replace=False)]
        if rng.random() < 0.3:
            vs = [-1] + vs
        ovs.append(vs)
    union = semirings._union_scope(ovs, [])
    out = [v for v in union if rng.random() < 0.4]
    ops = [rng.random(tuple(extent[v] for v in vs)) + 0.1 for vs in ovs]
    return ops, ovs, out


@pytest.mark.parametrize("n_ops", range(1, 10))
def test_contract_matches_jax(n_ops):
    ops, ovs, out = _random_operands(100 + n_ops, n_ops)
    want = np.asarray(JAX_SUM_PRODUCT.contract(ops, ovs, out))
    got = SUM_PRODUCT.contract(
        [torch.as_tensor(o, dtype=torch.float64) for o in ops], ovs, out
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_planner_takes_smallest_pair_first():
    """The pair with the fewest result states goes first (here the two
    operands that share variable 0, whose result keeps only the batch axis);
    ties break on the lowest (i, j)."""
    extent = {0: 4, 1: 100, 2: 4, -1: 8}
    steps = plan_contraction([[0, 1], [-1, 2], [-1, 0]], [-1], extent)
    assert steps == [(0, 2, [-1]), (0, 1, [-1])]
    tie = plan_contraction([[0], [1], [2]], [0, 1, 2], {0: 2, 1: 2, 2: 2})
    assert tie == [(0, 1, [0, 1]), (0, 1, [2, 0, 1])]


def test_planner_bound_on_hailfinder_program():
    """Every contraction of the rescaled serving program on hailfinder_like
    (B=128, evidence on every third variable, run on meta tensors so nothing
    is allocated): the largest pairwise intermediate never exceeds the
    batched largest clique, B * max_clique_states (1.59e9 states here), it is
    never larger than the left-to-right order's, and it is smaller on some
    contractions."""
    factors, sizes, _ = models.hailfinder_like(seed=0)
    plan = jt.compile_plan(factors, sizes)
    B = 128
    obs = list(range(0, plan.num_vars, 3))
    seen = []

    def left_to_right(ovs, out, ext):
        ops = [list(x) for x in ovs]
        worst = 0
        while len(ops) > 1:
            need = set(out).union(*ops[2:])
            res = [v for v in semirings._union_scope(ops[:2], []) if v in need]
            worst = max(worst, semirings._states(res, ext))
            ops = [res] + ops[2:]
        return worst

    def spy(ovs, out, ext):
        steps = plan_contraction(ovs, out, ext)
        greedy = max((semirings._states(r, ext) for _, _, r in steps), default=0)
        seen.append((greedy, left_to_right(ovs, out, ext)))
        return steps

    pots = [torch.empty(plan.clique_shape(c), device="meta")
            for c in range(plan.tri.num_cliques)]
    masks = [torch.empty((B, plan.sizes[v]), device="meta") for v in obs]
    mp = pytest.MonkeyPatch()
    mp.setattr(semirings, "plan_contraction", spy)
    try:
        margs, logz = batched_propagate_program(plan, observed=obs)(
            pots, masks
        )
    finally:
        mp.undo()
    assert tuple(logz.shape) == (B,)
    bound = B * plan.stats()["max_clique_states"]
    assert bound == 1_592_524_800
    assert seen and max(g for g, _ in seen) <= bound
    assert all(g <= l for g, l in seen)
    assert any(g < l for g, l in seen)
