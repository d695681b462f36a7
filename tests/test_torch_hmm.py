"""Hidden Markov models on the port's chain program: the HMM layout, its
program against a plain Li-Stephens forward-backward
(``tests/lshmm_reference.py``) and the general program, routing, the
other chain users left as they were, and the program's spans and
counters."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch import convert, learn_chain
from junctiontree_tpu_torch.models import chain_bn_model, grid_mrf_model, star_bn_model
from junctiontree_tpu_torch.models.hmm import (
    li_stephens_model,
    mutation_rate,
    typed_sites,
)
from junctiontree_tpu_torch.parallel import make_mesh
from junctiontree_tpu_torch.scan_executor import (
    ChainLayout,
    HMMLayout,
    StackedPosteriors,
)
from junctiontree_tpu_torch.utils.timing import TIMERS

from .lshmm_reference import forward_backward

K, M, B = 6, 9, 7
TYPED = {"every": typed_sites(M, 1), "third": typed_sites(M, 3), "none": []}


def _ls(seed=1):
    return li_stephens_model(K, M, seed=seed)


def _extended(seed=1):
    """The Li-Stephens model with a second binary leaf at x2 and a leaf of
    card 3 at x4 (each hidden variable of them then carries two leaves),
    and a unary on x4 that the plan folds into one of its cliques."""
    factors, sizes, values = _ls(seed)
    rng = np.random.default_rng(seed + 100)
    for label, h, c in (("z2", "x2", 2), ("w4", "x4", 3)):
        factors.append([label, h])
        sizes[label] = c
        values.append(rng.random((c, K)) + 0.1)
    factors.append(["x4"])
    values.append(rng.random(K) + 0.1)
    return factors, sizes, values


MODELS = {"ls": _ls, "extended": _extended}


def _masks(sizes, observed, seed):
    """One-hot masks of ``observed`` for B rows; row 0 impossible (the
    first observed variable has no allowed state)."""
    rng = np.random.default_rng(seed)
    out = {}
    for v in observed:
        m = np.zeros((B, sizes[v]))
        m[np.arange(B), rng.integers(sizes[v], size=B)] = 1.0
        out[v] = m
    if observed:
        out[observed[0]][0] = 0.0
    return out


def _case(model, typed, dtype=torch.float64):
    factors, sizes, values = MODELS[model]()
    observed = list(TYPED[typed])
    if model == "extended":
        # a hidden variable with evidence of its own, and the new leaves
        observed += ["x5", "w4"] + (["z2"] if typed != "none" else [])
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=dtype).set_potentials(values)
    return factors, sizes, values, tree, eng, _masks(sizes, observed, 7)


# -- the layout -------------------------------------------------------------

def test_detect_the_li_stephens_model():
    factors, sizes, _ = _ls()
    plan = jt.compile_plan(factors, sizes)
    assert ChainLayout.detect(plan) is None
    lay = HMMLayout.detect(plan)
    label = plan.table.label_of
    assert [label(v) for v in lay.chain.var_order] == [f"x{m}" for m in range(M)]
    assert lay.chain.card == K and len(lay.chain.clique_order) == M - 1
    assert [label(v) for v in lay.leaf_vars] == [f"y{m}" for m in range(M)]
    assert lay.leaf_pos == list(range(M)) and lay.groups == [(2, 0, M)]


def test_leaves_hang_off_either_side_in_the_tree():
    """The plan's tree hangs y0's clique off the chain clique after x0 and
    y8's off the one before x8; the layout reads both the same way."""
    factors, sizes, _ = _ls()
    plan = jt.compile_plan(factors, sizes)
    ids = plan.table.id_of
    clique = {frozenset(c): i for i, c in enumerate(plan.clique_vars)}
    nbrs = {}
    for a, b, _ in plan.tree.edges:
        nbrs.setdefault(a, set()).add(b)
        nbrs.setdefault(b, set()).add(a)
    y0 = clique[frozenset((ids("x0"), ids("y0")))]
    y8 = clique[frozenset((ids("x8"), ids("y8")))]
    assert nbrs[y0] == {clique[frozenset((ids("x0"), ids("x1")))]}
    assert nbrs[y8] == {clique[frozenset((ids("x7"), ids("x8")))]}
    lay = HMMLayout.detect(plan)
    assert lay.leaf_pos[0] == 0 and lay.leaf_pos[M - 1] == M - 1


def test_detect_the_extended_model():
    factors, sizes, _ = _extended()
    plan = jt.compile_plan(factors, sizes)
    lay = HMMLayout.detect(plan)
    label = plan.table.label_of
    assert lay.groups == [(2, 0, M + 1), (3, M + 1, M + 2)]
    # binary leaves: one at each position, then x2's second
    assert lay.leaf_pos == list(range(M)) + [2, 4]
    assert [label(v) for v in lay.leaf_vars[M:]] == ["z2", "w4"]


@pytest.mark.parametrize("case", ["chain", "star", "grid", "mixed", "branch"])
def test_detect_rejects(case):
    """A uniform chain is the chain program's; a star has no chain clique;
    a grid has bigger cliques; hidden variables of two cardinalities; a
    hidden tree that branches."""
    if case == "chain":
        factors, sizes, _ = chain_bn_model(6, card=3)
    elif case == "star":
        factors, sizes, _ = star_bn_model(5)
    elif case == "grid":
        factors, sizes, _ = grid_mrf_model(3, 3)
    elif case == "mixed":
        factors = [["a", "b"], ["b", "c"], ["a", "la"], ["b", "lb"],
                   ["c", "lc"]]
        sizes = {"a": 3, "b": 3, "c": 4, "la": 2, "lb": 2, "lc": 2}
    else:
        factors = [["h", "a"], ["h", "b"], ["h", "c"], ["a", "la"],
                   ["b", "lb"], ["c", "lc"]]
        sizes = {v: 3 for v in ("h", "a", "b", "c", "la", "lb", "lc")}
    plan = jt.compile_plan(factors, sizes)
    if case == "chain":
        assert ChainLayout.detect(plan) is not None
        eng = jt.Engine(plan, device="cpu")
        assert eng._hmm_layout() is None
        return
    assert HMMLayout.detect(plan) is None


# -- the program against the Li-Stephens recursion and the general program ---

def _ls_reference(tree, factors, sizes, values, masks):
    """The Li-Stephens recursion's (posteriors {label: [B, card]}, logZ)
    from the generator's prior, stay probabilities and emissions."""
    prior = torch.as_tensor(values[0])
    trans = [v for f, v in zip(factors, values) if f[0].startswith("x")
             and len(f) == 2 and f[1].startswith("x")]
    stay = torch.as_tensor([t[0, 0] - t[0, 1] for t in trans])
    emit = torch.as_tensor(np.stack(
        [v for f, v in zip(factors, values) if len(f) == 2
         and f[1].startswith("y")]))
    obs = {int(v[1:]): torch.as_tensor(m) for v, m in masks.items()}
    rows = B if masks else 1
    hidden, allele, logz = forward_backward(prior, stay, emit, obs, rows)
    post = {f"x{m}": hidden[m] for m in range(M)}
    post.update({f"y{m}": allele[m] for m in range(M)})
    return post, logz


@pytest.mark.parametrize("typed", sorted(TYPED))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_float64_program_matches_li_stephens_and_general(model, typed):
    """The HMM program against the port's general program and the JAX
    package's program (every variable id and logZ, 1e-10), and on the
    plain Li-Stephens model against the recursion."""
    factors, sizes, values, tree, eng, masks = _case(model, typed)
    assert eng._route("auto") == "hmm"
    post, logz = eng.posterior_batch(masks)
    assert isinstance(post, StackedPosteriors) and ("hmm",) in eng._programs
    assert len(post) == len(list(post)) == tree.plan.num_vars
    want, want_z = eng.posterior_batch(masks, mode="general")
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    jpost, jlogz = jeng.posterior_batch(masks)
    rows = B if masks else 1
    assert logz.shape == (rows,)
    for z in (want_z.numpy(), np.asarray(jlogz)):
        np.testing.assert_allclose(logz.numpy(), z, rtol=1e-10, atol=1e-10)
    for v in range(tree.plan.num_vars):
        for p in (want[v].numpy(), np.asarray(jpost[v])):
            np.testing.assert_allclose(post[v].numpy(), p, rtol=0,
                                       atol=1e-10)
    if masks:   # row 0 is impossible
        assert logz[0] == -np.inf and torch.isfinite(logz[1:]).all()
        assert all(not post[v][0].any() for v in range(len(post)))
    assert not any(torch.isnan(post[v]).any() for v in range(len(post)))
    if model != "ls":
        return
    ref, ref_z = _ls_reference(tree, factors, sizes, values, masks)
    np.testing.assert_allclose(logz.numpy(), ref_z.numpy(), rtol=1e-10,
                               atol=1e-10)
    label = tree.plan.table.label_of
    for v in range(tree.plan.num_vars):
        np.testing.assert_allclose(post[v].numpy(), ref[label(v)].numpy(),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("typed", sorted(TYPED))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_float32_program_within_float32_rounding(model, typed):
    """float32 against the float64 general program.  Posteriors within 2e-6
    absolute: about 17 rounding errors of float32 (eps 6e-8) through the
    nine sites' products of six terms, the rescaling and the leaves'
    division and product; logZ within 2e-6 relative, the same errors in a
    sum of nine logs, or 2e-6 absolute where logZ is near 0 (no
    evidence)."""
    _, _, values, tree, eng32, masks = _case(model, typed, torch.float32)
    eng64 = tree.engine(device="cpu", dtype=torch.float64).set_potentials(
        values)
    post, logz = eng32.posterior_batch(masks)
    want, want_z = eng64.posterior_batch(masks, mode="general")
    assert post[0].dtype == torch.float32
    ok = torch.isfinite(want_z)
    assert torch.equal(torch.isfinite(logz), ok)
    np.testing.assert_allclose(logz[ok].double().numpy(),
                               want_z[ok].numpy(), rtol=2e-6, atol=2e-6)
    for v in range(tree.plan.num_vars):
        np.testing.assert_allclose(post[v].double().numpy(),
                                   want[v].numpy(), rtol=0, atol=2e-6)


def test_leaf_row_sums_are_not_taken_as_one():
    """Emission rows that do not sum to 1 (an unnormalized potential):
    the unobserved leaves' row sums weigh the hidden states."""
    factors, sizes, values = _ls()
    values = [v * (1.0 + np.arange(K)[:, None]) if f[-1].startswith("y")
              else v for f, v in zip(factors, values)]
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    masks = _masks(sizes, ["y4"], 3)
    post, logz = eng.posterior_batch(masks)
    want, want_z = eng.posterior_batch(masks, mode="general")
    np.testing.assert_allclose(logz.numpy(), want_z.numpy(), rtol=1e-10)
    for v in range(tree.plan.num_vars):
        np.testing.assert_allclose(post[v].numpy(), want[v].numpy(),
                                   atol=1e-10)


def test_stacks_follow_set_potentials():
    factors, sizes, values, tree, eng, masks = _case("ls", "third")
    eng.posterior_batch(masks)
    stacks = eng._hmm_stacks
    eng.posterior_batch(masks)
    assert eng._hmm_stacks is stacks
    other = li_stephens_model(K, M, seed=2)[2]
    post, _ = eng.set_potentials(other).posterior_batch(masks)
    assert eng._hmm_stacks is not stacks
    want, _ = eng.posterior_batch(masks, mode="general")
    np.testing.assert_allclose(post[0].numpy(), want[0].numpy(), atol=1e-10)


def test_generator_settings():
    """theta is the inverse harmonic number; emissions and transitions are
    distributions; every site of the panel is polymorphic."""
    assert mutation_rate(4) == pytest.approx(1 / (1 + 1 / 2 + 1 / 3))
    factors, sizes, values = li_stephens_model(50, 30, seed=5)
    assert len(factors) == 1 + 29 + 30 and sizes["x0"] == 50
    for f, v in zip(factors, values):
        np.testing.assert_allclose(np.sum(v, axis=-1), 1.0, rtol=1e-12)
    emits = np.stack([v for f, v in zip(factors, values) if f[-1][0] == "y"])
    carriers = (emits[:, :, 1] > 0.5).sum(axis=1)
    assert carriers.min() >= 1 and carriers.max() <= 49
    assert typed_sites(256) == [f"y{m}" for m in range(0, 256, 10)]


# -- routing, and the other users of the chain layout -------------------------

def test_uniform_chain_keeps_its_program():
    factors, sizes, values = chain_bn_model(10, card=3, seed=2)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    masks = _masks(sizes, ["x4"], 1)
    post, _ = eng.posterior_batch(masks)
    assert eng._route("auto") == "chain" and eng._hmm_layout() is None
    assert ("chain",) in eng._programs and ("hmm",) not in eng._programs
    assert eng._hmm_stacks is None and eng._chain_A is not None
    assert isinstance(post, StackedPosteriors) and len(post) == 10


def test_general_and_log_engines_leave_the_hmm_program():
    factors, sizes, values, tree, eng, masks = _case("ls", "third")
    assert eng._route("general") == "general"
    eng.posterior_batch(masks, mode="general")
    assert ("hmm",) not in eng._programs
    for semiring in ("log_sum_exp", "max_product"):
        leng = tree.engine(semiring, device="cpu")
        assert leng._route("auto") == "general"


def test_map_and_kbest_on_an_hmm_as_the_jax_package():
    """No chain layout, so MAP takes the tree-MAP program and k-best the
    tree's, as before the HMM route; both agree with the JAX package."""
    factors, sizes, values, tree, eng, masks = _case("ls", "third")
    assert eng._chain_layout() is None
    with np.errstate(divide="ignore"):
        log_masks = {k: np.log(v) for k, v in masks.items()}
    assign, score = eng.map_assignment_batch(log_masks)
    assert ("viterbi",) not in eng._max_delegate()._programs
    assert any(k[0] == "tree_map" for k in eng._max_delegate()._programs)
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    jassign, jscore = jeng.map_assignment_batch(log_masks)
    ok = np.isfinite(np.asarray(jscore))
    np.testing.assert_allclose(score.numpy()[ok], np.asarray(jscore)[ok],
                               rtol=1e-9)
    assert (score.numpy()[~ok] < -1e29).all()
    evidence = {"y0": 1, "y3": 0}
    got = eng.top_k_assignments(evidence, k=4)
    want = jeng.top_k_assignments(evidence, k=4)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-9)


def test_learn_chain_and_convert_refuse_an_hmm():
    factors, sizes, values = _ls()
    plan = jt.compile_plan(factors, sizes)
    with pytest.raises(ValueError, match="uniform chain"):
        learn_chain.fit_mle_chain(plan, np.zeros((4, plan.num_vars), int),
                                  steps=1, device="cpu")
    tree = jt.create_junction_tree(factors, sizes)
    pots = tree.engine(device="cpu").set_potentials(values)._pots_np
    with pytest.raises(ValueError, match="uniform chain"):
        convert.chain_stack_from_numpy(plan.to_json(), pots)
    eng = convert.engine_from_numpy(plan.to_json(), pots, device="cpu",
                                    dtype=torch.float64)
    masks = _masks(sizes, ["y1", "y5"], 2)
    post, logz = eng.posterior_batch(masks)
    want, want_z = eng.posterior_batch(masks, mode="general")
    assert ("hmm",) in eng._programs
    np.testing.assert_allclose(logz.numpy(), want_z.numpy(), rtol=1e-10)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_shard_batch_joins_every_variable(model):
    """Each device's replica serves its rows on the HMM program; the joined
    result maps every variable id, hidden and leaf, as unsharded."""
    factors, sizes, values, tree, eng, masks = _case(model, "third")
    want, want_z = eng.posterior_batch(masks)
    sharded = tree.engine(device="cpu", dtype=torch.float64).set_potentials(
        values).shard_batch(make_mesh(devices=["cpu"] * 2))
    post, logz = sharded.posterior_batch(masks)
    assert all(("hmm",) in r._programs for r in sharded._replicas.values())
    assert len(sharded._row_split(masks)[1]) == 2
    assert isinstance(post, StackedPosteriors)
    assert len(post) == len(list(post)) == tree.plan.num_vars
    np.testing.assert_allclose(logz.numpy(), want_z.numpy(), rtol=1e-12,
                               atol=0)
    for v in range(tree.plan.num_vars):
        assert post[v].shape == want[v].shape
        np.testing.assert_allclose(post[v].numpy(), want[v].numpy(), rtol=0,
                                   atol=1e-12)


def test_shard_sequence_leaves_an_hmm_sequential():
    factors, sizes, values, tree, eng, masks = _case("ls", "third")
    want, want_z = eng.posterior_batch(masks)
    eng.shard_sequence(make_mesh(devices=["cpu"] * 2), min_len=2)
    post, logz = eng.posterior_batch(masks)
    assert ("chain_parallel",) not in eng._programs
    assert torch.equal(logz, want_z)
    assert all(torch.equal(post[v], want[v]) for v in range(len(post)))


# -- spans and counters -------------------------------------------------------

def test_spans_and_counters_under_the_profiler():
    factors, sizes, values, tree, eng, masks = _case("extended", "third")
    eng.posterior_batch(masks)
    before = TIMERS.counters()
    eng.posterior_batch(masks)
    after = TIMERS.counters()
    leaves = M + 2
    assert after["chain.products"] - before["chain.products"] == 2 * (M - 1)
    assert after["chain.leaf_vars"] - before["chain.leaf_vars"] == leaves
    with profile(activities=[ProfilerActivity.CPU]):
        eng.posterior_batch(masks)
    call = TIMERS.calls()[-1]
    assert call.name == "serve.posterior_batch"
    names = [s.name for s in call.spans]
    assert names.count("chain.leaves") == 2
    assert names.index("chain.leaves") < names.index("chain.forward") \
        < names.index("chain.backward")
    fwd, bwd = call.named("chain.forward")[0], call.named("chain.backward")[0]
    for s in (fwd, bwd):
        assert {k: s.attrs[k] for k in ("M", "B", "K")} == {
            "M": M, "B": B, "K": K}
        assert s.attrs["products"] == [[M - 1, B, K, K]]
        assert call.spans[s.parent].name == "serve.posterior_batch"
    fold, out = call.named("chain.leaves")
    observed = len(TYPED["third"]) + 2      # y0, y3, y6, w4 and z2
    assert fold.attrs["leaves"] == observed and fold.attrs["C"] == [2, 3]
    assert fold.attrs["products"] == [[observed - 1, B, 2, K], [1, B, 3, K]]
    assert out.attrs["leaves"] == leaves
    assert out.attrs["products"] == [[M + 1, B, K, 2], [observed - 1, B, K, 2],
                                     [1, B, K, 3], [1, B, K, 3]]
    assert call.counters["chain.products"] == 2 * (M - 1)
    assert call.counters["chain.leaf_vars"] == leaves


def test_uniform_chain_records_its_passes():
    factors, sizes, values = chain_bn_model(8, card=3, seed=2)
    eng = jt.create_junction_tree(factors, sizes).engine(
        device="cpu").set_potentials(values)
    masks = _masks(sizes, ["x2"], 1)
    eng.posterior_batch(masks)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.posterior_batch(masks)
    call = TIMERS.calls()[-1]
    assert [s.name for s in call.spans[1:] if s.name.startswith("chain.")] \
        == ["chain.forward", "chain.backward"]
    assert call.counters["chain.products"] == 14
    assert call.counters["chain.leaf_vars"] == 0
