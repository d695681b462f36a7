"""What the route keeps beside a standing potential for the kernel
(``ops.factored_contract.kept``, ``StandingLayout``), on CPU tensors.

The card keeps, per (tensor, layout), the float32 split's bf16 planes or
the bfloat16 rows that a launch reads, for the tensors an engine marks as
standing (its potentials), at most as many layouts as one call routes to
the clique.  Here the keep logic runs with the
split's plain version (``reference_split_pot``) as what is made, and the
serving path runs with a stand-in for the kernel that reads only what was
kept, so that anything kept too long shows in the results.  Imports no JAX.
"""

import gc

import numpy as np
import pytest
import torch

import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS


def _split_maker(pot, by_n, bk, planes, made):
    """``make`` for ``kept``: the plain split of ``pot``, counted."""
    def make():
        made.append((by_n, bk, planes))
        buf, exps = fc.reference_split_pot(pot, by_n, bk, planes)
        return fc.Operand(buf, int(buf.shape[-1]), exps)
    return make


def _pot(seed=0, shape=(4, 96, 2), layouts=4):
    """A standing potential: marked, so that ``kept`` keeps for it."""
    pot = torch.as_tensor(np.random.default_rng(seed).random(shape),
                          dtype=torch.float32)
    fc.standing(pot, layouts)
    return pot


@pytest.mark.parametrize("by_n,bk,planes", [(True, 32, 3), (False, 32, 1)])
def test_same_tensor_and_layout_hits(by_n, bk, planes):
    pot, made = _pot(), []
    key = ("axes", by_n, bk, planes)
    first = fc.kept(pot, key, _split_maker(pot, by_n, bk, planes, made))
    hits = TIMERS.counters()["kept.hits"]
    again = fc.kept(pot, key, _split_maker(pot, by_n, bk, planes, made))
    assert again is first and len(made) == 1
    assert TIMERS.counters()["kept.hits"] == hits + 1
    want, want_exps = fc.reference_split_pot(pot, by_n, bk, planes)
    assert torch.equal(again.buf, want) and torch.equal(again.exps, want_exps)


@pytest.mark.parametrize("other", ["layout", "planes", "tiling", "stage"])
def test_another_layout_planes_or_tiling_misses(other):
    """The key holds the layout's axes, the tiling (by_n), the stage depth
    (bk) and the number of planes: a change in any one is a new entry."""
    pot, made = _pot(1), []
    base = dict(axes=((0,), (1,), (2,)), by_n=True, bk=32, planes=3)
    key = tuple(base.values())
    fc.kept(pot, key, _split_maker(pot, True, 32, 3, made))
    alt = dict(base)
    alt.update({"layout": {"axes": ((1,), (0,), (2,))},
                "planes": {"planes": 1}, "tiling": {"by_n": False},
                "stage": {"bk": 64}}[other])
    got = fc.kept(pot, tuple(alt.values()), _split_maker(
        pot, alt["by_n"], alt["bk"], alt["planes"], made))
    assert len(made) == 2
    assert got.buf.shape[0] == alt["planes"]
    assert len(fc.kept_sizes(pot)) == 2


@pytest.mark.parametrize("through_view", [False, True])
def test_in_place_edit_drops_what_was_kept(through_view):
    pot, made = _pot(2), []
    key = ("k", True, 32, 3)
    fc.kept(pot, key, _split_maker(pot, True, 32, 3, made))
    fc.kept(pot, ("other", False, 32, 3), _split_maker(pot, False, 32, 3, made))
    if through_view:
        pot[0].mul_(2.0)  # views share the version counter
    else:
        pot.mul_(2.0)
    assert fc.kept_sizes(pot) == []
    got = fc.kept(pot, key, _split_maker(pot, True, 32, 3, made))
    assert len(made) == 3
    assert torch.equal(got.buf, fc.reference_split_pot(pot, True, 32, 3)[0])
    assert len(fc.kept_sizes(pot)) == 1


def test_nothing_kept_for_a_tensor_that_requires_grad():
    """Neither a tensor marked while it requires a gradient nor a marked
    one that later does keeps anything."""
    key = ("k", True, 32, 3)
    for late in (False, True):
        pot, made = _pot(3), []
        if not late:
            pot = pot.clone().requires_grad_(True)
            fc.standing(pot, 4)
            assert pot not in fc._KEPT
        else:
            pot.requires_grad_(True)
        with torch.enable_grad():
            for _ in range(2):
                fc.kept(pot, key, _split_maker(pot.detach(), True, 32, 3, made))
        assert len(made) == 2 and fc.kept_sizes(pot) == []


def test_nothing_kept_for_an_unmarked_tensor():
    """A tensor the route makes for one call (a product with messages, a
    derived potential) is never marked: its operand is made on every call
    and nothing is held for it."""
    pot = torch.as_tensor(np.random.default_rng(7).random((4, 96, 2)),
                          dtype=torch.float32)
    made, before = [], len(fc._KEPT)
    for _ in range(2):
        fc.kept(pot, ("k",), _split_maker(pot, True, 32, 3, made))
    assert len(made) == 2 and len(fc._KEPT) == before
    assert fc.kept_sizes(pot) == [] and fc._entry(pot) is None


def test_inference_tensors_are_never_kept():
    """An inference tensor has no version counter: one made under
    ``torch.inference_mode()`` is not marked, and reading it there makes
    its operand on every call without raising; a marked tensor read under
    inference mode keeps its operand as outside it."""
    with torch.inference_mode():
        inf = torch.ones((4, 96, 2))
        fc.standing(inf, 4)
        made = []
        for _ in range(2):
            fc.kept(inf, ("k",), _split_maker(inf, True, 32, 3, made))
        assert len(made) == 2 and fc.kept_sizes(inf) == []
    assert fc._entry(inf) is None
    pot, made = _pot(8), []
    with torch.inference_mode():
        for _ in range(2):
            fc.kept(pot, ("k",), _split_maker(pot, True, 32, 3, made))
    assert len(made) == 1 and len(fc.kept_sizes(pot)) == 1


def test_entry_dies_with_its_tensor():
    pot, made = _pot(4), []
    fc.kept(pot, ("k",), _split_maker(pot, True, 32, 3, made))
    before = len(fc._KEPT)
    assert pot in fc._KEPT
    del pot
    gc.collect()
    assert len(fc._KEPT) == before - 1


def test_a_new_tensor_at_the_same_address_never_shares_an_entry():
    """Two tensors over one buffer, the first gone before the second is
    made: same address, same shape, another object, so another entry."""
    arr = np.random.default_rng(5).random((4, 96, 2)).astype(np.float32)
    made = []
    first = torch.from_numpy(arr)
    addr = first.data_ptr()
    fc.kept(first, ("k",), _split_maker(first, True, 32, 3, made))
    del first
    gc.collect()
    second = torch.from_numpy(arr)
    assert second.data_ptr() == addr
    fc.kept(second, ("k",), _split_maker(second, True, 32, 3, made))
    assert len(made) == 2


def test_kept_layouts_are_bounded_least_recently_used_out():
    """At most ``layouts`` keys: a new key past them serves its call alone
    while the kept ones are in use, and puts the least recently used out
    once more than ``layouts`` misses have passed since that one was last
    used."""
    cap = 5
    pot, made = _pot(6, (2, 3, 2), layouts=cap), []

    def look(key):
        n = len(made)
        fc.kept(pot, (key,), _split_maker(pot, True, 32, 1, made))
        return len(made) > n  # made, so missed

    assert all(look(i) for i in range(cap))
    assert not look(0)                      # 0 used last, at miss 5
    assert look(cap) and look(cap)          # misses 6, 7: not kept
    assert len(fc.kept_sizes(pot)) == cap
    assert not any(look(i) for i in range(cap))  # none went out
    for k in range(cap + 1, 2 * cap + 2):   # misses 8..13
        assert look(k)
    # 0 was last used at miss 7, 6 misses before the last new key: out
    assert not look(2 * cap + 1) and look(0)
    assert len(fc.kept_sizes(pot)) == cap


@pytest.mark.parametrize("C", [2, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_standing_layout_is_the_routes_view(C, dtype):
    """``StandingLayout.tensor()`` is the [R1, R2, C] view the route made
    before, and the wrapper takes a layout where it takes that tensor."""
    pot = torch.as_tensor(np.random.default_rng(C).random((3, 4, 2, 6, C)),
                          dtype=torch.float32).to(dtype)
    r1, r2, c = [3, 0], [1, 2], [4]
    by_n = fc.tiles_by_n(C)
    lay = fc.StandingLayout(pot, r1, r2, c, by_n)
    assert lay.shape == (18, 8, C)  # float32 N = 36: the tensor cores
    want = pot.permute(r1 + r2 + c).reshape(18, 8, C)
    assert torch.equal(lay.tensor(), want)
    w1 = torch.rand((7, 18)).to(dtype)
    w2 = torch.rand((7, 8)).to(dtype)
    got = fc.factored_masked_contract(lay, w1, w2)
    assert torch.equal(got, fc.factored_masked_contract(want, w1, w2))


@pytest.mark.parametrize("shape", [(2, 3, 2, 5, 2, 3), (2,) * 7, (3, 40, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_bytes_bound_is_the_worst_grouping(shape, dtype):
    """``layout_bytes_bound`` in closed form equals the largest operand
    over every grouping of the axes into r1, r2 and c and both
    precisions, enumerated: the plain split's planes and exponents in
    float32 (nothing where the narrow CUDA-core route takes it), the
    padded bf16 rows in bfloat16."""
    import itertools

    worst = 0
    for groups in itertools.product(range(3), repeat=len(shape)):
        R1, R2, C = (int(np.prod([k for k, g in zip(shape, groups) if g == i]))
                     for i in range(3))
        by_n = fc.tiles_by_n(C)
        for precision in fc.PRECISIONS:
            src = fc.source(dtype == torch.bfloat16, precision,
                            R1 * C if by_n else None)
            if src == "fma":
                continue
            if dtype == torch.bfloat16:
                ld = -(-(R1 * C if by_n else C) // 8) * 8
                nbytes = 2 * (R2 if by_n else R1 * R2) * ld
            else:
                planes, exps = fc.reference_split_pot(
                    torch.zeros((R1, R2, C)), by_n, fc.BK[src],
                    fc.PLANES[src])
                nbytes = 2 * planes.numel() + 4 * exps.numel()
            worst = max(worst, nbytes)
    assert fc.layout_bytes_bound(shape, dtype) == worst
    states = int(np.prod(shape))
    if dtype == torch.bfloat16:  # Z in rows of one column: 8 x 2 B a state
        assert worst == 16 * states


def _big_clique(n=18, seed=0):
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(n)]
    factors = [names[:]] + [[v] for v in names]
    values = [rng.random((2,) * n) + 0.1] + [rng.random(2) + 0.1
                                               for _ in names]
    return jt.create_junction_tree(factors, {v: 2 for v in names}), values, names


def test_max_feasible_batch_counts_the_kept_bytes_on_the_big_clique():
    """On the card (the closed form holds on meta tensors too) the 2^18-state
    clique's potential keeps at most 19 layouts (18 marginals and Z), each
    at most ``layout_bytes_bound``: 6.0625 B a state in float32, 16 B in
    bfloat16 (rows of one column, padded to 8); a bfloat16 engine keeps for
    its float32 potentials and its bfloat16 storage copies.  The CPU keeps
    nothing."""
    tree, _, _ = _big_clique()
    states = 1 << 18
    cpu = jt.Engine(tree.plan, device="cpu")
    assert cpu._kept_bytes_bound() == 0
    meta = jt.Engine(tree.plan, device="meta")
    assert meta._kept_layouts(0) == 19
    f32 = fc.layout_bytes_bound((2,) * 18, torch.float32)
    bf16 = fc.layout_bytes_bound((2,) * 18, torch.bfloat16)
    # three bf16 planes, and at worst one int32 exponent a 64-state row
    # (the "c" tiling at C = 64, R2 = 1)
    assert f32 == 6 * states + 4 * (states // 64) and bf16 == 16 * states
    for dtype, per_layout in ((torch.float32, f32),
                              (torch.bfloat16, f32 + bf16)):
        meta = jt.Engine(tree.plan, device="meta", dtype=dtype)
        kept = meta._kept_bytes_bound()
        assert kept == 19 * per_layout
        st = meta.plan.stats()
        itemsize = 2 if dtype == torch.bfloat16 else 4
        per_query = itemsize * int(
            meta.ROW_CLIQUES["posterior"] * st["max_clique_states"]
            + 2 * sum(2 for _ in meta.plan.tree.separators))
        held = itemsize * st["total_clique_states"]
        budget = held + kept + 5 * per_query
        assert meta.max_feasible_batch(budget) == 4
        # without the kept bytes the same budget holds more rows
        assert jt.Engine(tree.plan, device="cpu", dtype=dtype) \
            .max_feasible_batch(held + 5 * per_query) == 4
        assert meta.max_feasible_batch(held + 5 * per_query) == 1


def test_kept_layouts_of_a_clique_with_neighbours():
    """One call routes to a clique one contraction for each of its
    variables, each neighbour's message and Z: that many layouts are kept
    at most."""
    from junctiontree_tpu_torch.models import grid_mrf_model

    plan = jt.create_junction_tree(*grid_mrf_model(3, 3, seed=0)[:2]).plan
    eng = jt.Engine(plan, device="meta")
    tree = plan.tree
    for c in range(plan.tri.num_cliques):
        nbrs = len(tree.children[c]) + int(tree.parent[c] >= 0)
        assert eng._kept_layouts(c) == len(plan.clique_vars[c]) + nbrs + 1


def test_no_kept_bytes_where_no_contraction_reaches_the_kernel():
    from junctiontree_tpu_torch.models import grid_mrf_model

    f, s, v = grid_mrf_model(3, 3, seed=0)
    plan = jt.create_junction_tree(f, s).plan
    assert jt.Engine(plan, device="meta")._kept_bytes_bound() == 0


def test_no_kept_bytes_where_big_cliques_never_reach_the_kernel():
    """hailfinder_like has cliques above the route's threshold, but every
    contraction on them has a message that crosses its output separator:
    the meta run hands no potential over, and nothing is counted.  The big
    clique's potential is handed over by the same run."""
    from junctiontree_tpu_torch.models import hailfinder_like

    f, s, v = hailfinder_like()
    plan = jt.create_junction_tree(f, s).plan
    assert plan.stats()["max_clique_states"] >= \
        jt.config.DEFAULT.big_clique_min_states
    meta = jt.Engine(plan, device="meta")
    assert meta._kept_bytes_bound() == 0
    tree, _, _ = _big_clique()
    assert jt.Engine(tree.plan, device="meta")._kept_bytes_bound() > 0


def test_handed_counts_the_standing_hand_overs(monkeypatch):
    """``handed`` counts the route's contractions that hand a marked
    potential over (on the CPU too, where the plain version then reads
    it); a product the route made for the call is never counted."""
    monkeypatch.setattr(jt.config.DEFAULT, "big_clique_min_states", 1 << 10)
    tree, values, names = _with_children()
    eng = tree.engine(device="cpu").set_potentials(values)
    big = max(range(tree.plan.tri.num_cliques),
              key=lambda c: len(tree.plan.clique_vars[c]))
    for observed, calls in ((names[6:9], 0),
                            (["u0", "u1", "u2", "u3"] + names[6:9], None)):
        before = fc.handed(eng._pots[big])
        eng.posterior_batch(jt.batch_masks_sparse(
            tree.plan, jt.random_evidence_batch(tree.plan, 4, observed, seed=9)))
        got = fc.handed(eng._pots[big]) - before
        assert got == calls if calls is not None else got > 0


def _kept_copy_contract(monkeypatch, seen=None):
    """Stand-ins for the card on the CPU: the route hands a standing
    potential over as a ``StandingLayout``, and the "kernel" reads only
    the copy kept for that layout, so that a stale copy shows."""
    monkeypatch.setattr(fc, "_hand_over",
                        lambda pot: fc._entry(pot) is not None)
    inner = fc._contract_on_device

    def on_kept(pot, w1, w2, backward=False, precision="highest"):
        if isinstance(pot, fc.StandingLayout):
            if seen is not None:
                seen.append(pot.pot)
            pot = fc.kept(pot.pot, pot.key, lambda: fc.Operand(
                pot.tensor().clone(), 0)).buf
        return inner(pot, w1, w2, backward, precision)

    monkeypatch.setattr(fc, "_contract_on_device", on_kept)


def _posteriors(eng, masks):
    post, logz = eng.posterior_batch(masks)
    return [p.clone() for p in post], logz.clone()


def _assert_same(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1])


def test_results_after_set_potentials_multiply_factor_and_load(
        monkeypatch, tmp_path):
    """A live engine whose kept operands are reused across calls gives,
    after ``set_potentials``, ``multiply_factor`` and ``load``, what a
    freshly built engine gives, bit for bit."""
    _kept_copy_contract(monkeypatch)
    tree, values, names = _big_clique(14, seed=1)
    monkeypatch.setattr(jt.config.DEFAULT, "big_clique_min_states", 1 << 10)
    evs = jt.random_evidence_batch(tree.plan, 6, names[:8], seed=2)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    eng = tree.engine(device="cpu").set_potentials(values)
    hits = TIMERS.counters()["kept.hits"]
    first = _posteriors(eng, masks)
    _assert_same(first, _posteriors(eng, masks))
    # every layout, again
    assert TIMERS.counters()["kept.hits"] - hits >= len(names) + 1

    new = [v * (1.0 + 0.5 * np.arange(v.size).reshape(v.shape) / v.size)
           for v in values]
    eng.set_potentials(new)
    _assert_same(_posteriors(eng, masks),
                 _posteriors(tree.engine(device="cpu").set_potentials(new),
                             masks))

    factor = np.array([[1.0, 3.0], [0.5, 2.0]])
    eng.multiply_factor([names[3], names[9]], factor)
    fresh = tree.engine(device="cpu").set_potentials(new)
    fresh.multiply_factor([names[3], names[9]], factor)
    got = _posteriors(eng, masks)
    _assert_same(got, _posteriors(fresh, masks))
    assert not all(torch.equal(x, y) for x, y in zip(got[0], first[0]))

    path = str(tmp_path / "eng.npz")
    eng.save(path)
    loaded = jt.Engine.load(path, device="cpu")
    _posteriors(loaded, masks)
    _assert_same(_posteriors(loaded, masks), got)


def test_describe_reports_the_kept_layouts(monkeypatch):
    _kept_copy_contract(monkeypatch)
    # 2^13 states: above the program's cap for a materialized belief, so
    # each marginal and Z is its own routed contraction
    tree, values, names = _big_clique(13, seed=3)
    monkeypatch.setattr(jt.config.DEFAULT, "big_clique_min_states", 1 << 10)
    masks = jt.batch_masks_sparse(
        tree.plan, jt.random_evidence_batch(tree.plan, 4, names[:6], seed=4))
    eng = tree.engine(device="cpu").set_potentials(values)
    assert eng.describe()["kept_layouts"] == {"layouts": 0, "bytes": 0}
    eng.posterior_batch(masks)
    rep = eng.describe()["kept_layouts"]
    assert rep["layouts"] == len(names) + 1
    assert rep["bytes"] == rep["layouts"] * 4 * (1 << 13)


def _with_children(n=13, kids=4, seed=5):
    """The big clique with ``kids`` of its variables each in a child clique
    of two: the route then also contracts products of the potential with
    unbatched messages, made anew on each call."""
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(n)]
    factors = [names[:]] + [[v] for v in names]
    values = [rng.random((2,) * n) + 0.1] + [rng.random(2) + 0.1
                                               for _ in names]
    for i in range(kids):
        factors.append([names[i], f"u{i}"])
        values.append(rng.random((2, 2)) + 0.1)
    sizes = {v: 2 for f in factors for v in f}
    return jt.create_junction_tree(factors, sizes), values, names


def test_only_the_engines_potentials_are_kept(monkeypatch):
    """Every operand kept belongs to one of the engine's potentials; the
    products the route makes for one call, and entropy's derived tensor,
    are handed over as plain tensors and leave nothing behind."""
    seen = []
    _kept_copy_contract(monkeypatch, seen)
    monkeypatch.setattr(jt.config.DEFAULT, "big_clique_min_states", 1 << 10)
    tree, values, names = _with_children()
    eng = tree.engine(device="cpu").set_potentials(values)
    calls = TIMERS.counters()["big_clique_sep_message.calls"]
    # with evidence below every child its messages are batched and the
    # potential itself is contracted; without, each contraction takes the
    # potential times the children's unbatched messages
    for observed in (["u0", "u1", "u2", "u3"] + names[6:9], names[6:9]):
        masks = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
            tree.plan, 4, observed, seed=6))
        eng.posterior_batch(masks)
        eng.entropy_batch(masks)
    routed = TIMERS.counters()["big_clique_sep_message.calls"] - calls
    standing = eng._standing()
    assert seen and len(seen) < routed
    assert all(any(p is q for q in standing) for p in seen)


def test_kept_layouts_follow_the_evidence_pattern(monkeypatch):
    """Alternating two and then three evidence patterns, then staying on
    one: a call that repeats the last call's pattern finds every layout;
    under alternation the layouts in use stay kept and the others serve
    their call alone; a pattern that stays is kept within one call's
    misses.  What is kept never exceeds one call's layouts, and every call
    gives the bits of a fresh engine's."""
    _kept_copy_contract(monkeypatch)
    monkeypatch.setattr(jt.config.DEFAULT, "big_clique_min_states", 1 << 10)
    tree, values, names = _big_clique(13, seed=7)
    pats = [names[:6], names[7:], names[2:4]]
    masks = [jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, 4, p, seed=8)) for p in pats]
    want = [_posteriors(tree.engine(device="cpu").set_potentials(values), m)
            for m in masks]
    eng = tree.engine(device="cpu").set_potentials(values)
    cap = eng._kept_layouts(0)
    order = [0, 0, 1, 0, 1, 0, 1, 2, 0, 1, 2] + [2] * (cap + 1)
    made = []
    for i in order:
        misses = TIMERS.counters()["kept.misses"]
        got = _posteriors(eng, masks[i])
        made.append(TIMERS.counters()["kept.misses"] - misses)
        _assert_same(got, want[i])
        assert eng.describe()["kept_layouts"]["layouts"] <= cap
    assert made[0] == cap and made[1] == 0 and made[-1] == 0
    assert all(m <= cap for m in made)
    assert made[3] == made[5] == 0  # pattern 0 stays kept under alternation
    # staying on pattern 2 costs its new layouts until the old ones are
    # stale (more than one call's misses), then makes what it lacks
    assert sum(made[len(order) - cap - 1:]) <= 2 * cap + 1
