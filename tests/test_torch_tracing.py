"""The port's recorder of spans and counters (``utils.timing.TIMERS``) on
the serving path, on CPU tensors.

Spans are recorded only while a ``torch.profiler`` records: one call
record per serving call, its spans nested under the entry point's root,
each stamped on the profiler's clock and entered as a ``record_function``
range.  Counters are always on.  Imports no JAX.
"""

import json
import math
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.parallel import make_mesh
from junctiontree_tpu_torch.utils import timing
from junctiontree_tpu_torch.utils.timing import TIMERS, device_trace

N, OBSERVED, B = 13, 6, 8   # a 2^13-state clique: marginals per variable


def _big_clique(n=N, seed=0):
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(n)]
    factors = [names[:]] + [[v] for v in names]
    values = [rng.random((2,) * n) + 0.1] + [rng.random(2) + 0.1
                                               for _ in names]
    return jt.create_junction_tree(factors, {v: 2 for v in names}), values, names


@pytest.fixture
def routed(monkeypatch):
    """The big clique's contractions take the factored route on the CPU."""
    monkeypatch.setattr(jt.config.DEFAULT, "big_clique_min_states", 1 << 10)
    tree, values, names = _big_clique()
    masks = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, B, names[:OBSERVED], seed=3))
    return tree, values, names, masks


def _log(masks):
    with np.errstate(divide="ignore"):
        return {k: np.log(v) for k, v in masks.items()}


def _itemsize(eng):
    return torch.empty((), dtype=eng.compute_dtype).element_size()


def _traced(*fns):
    """Run ``fns`` under a CPU profiler (after one warm call of each, so that
    first-use costs stay out); the call records of the second runs and the
    profiler's annotation events by name."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for fn in fns:
            fn()
        TIMERS.reset()
        for fn in fns:
            fn()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return TIMERS.calls(), events


# -- off -----------------------------------------------------------------------

@pytest.mark.parametrize("surface", ["posterior", "map"])
def test_off_outside_a_profiler(routed, monkeypatch, surface):
    """Outside a profiler a serving call records no call, reads no span
    clock and never enters ``record_function``."""
    tree, values, _, masks = routed
    if surface == "posterior":
        eng = tree.engine(device="cpu").set_potentials(values)
        call = lambda: eng.posterior_batch(masks)        # noqa: E731
    else:
        eng = tree.engine("max_product", device="cpu").set_potentials(values)
        call = lambda: eng.map_assignment_batch(_log(masks))  # noqa: E731
    call()   # the program is built outside the patches

    def boom(*a, **k):
        raise AssertionError("a span read the clock or entered a range")

    monkeypatch.setattr(timing, "time", types.SimpleNamespace(
        perf_counter=timing.time.perf_counter, time_ns=boom))
    monkeypatch.setattr(timing, "_autograd_profiler", types.SimpleNamespace(
        _is_profiler_enabled=False, record_function=boom))
    TIMERS.reset()
    call()
    assert TIMERS.calls() == []


# -- spans ---------------------------------------------------------------------

def test_one_root_per_call_with_the_steps_under_it(routed):
    tree, values, _, masks = routed
    eng = tree.engine(device="cpu").set_potentials(values)
    calls, _ = _traced(lambda: eng.posterior_batch(masks),
                       lambda: eng.posterior_batch(masks))
    assert [c.name for c in calls] == ["serve.posterior_batch"] * 2
    assert calls[0].id != calls[1].id
    for c in calls:
        root = c.spans[0]
        assert root.parent is None
        assert all(s.call == c.id for s in c.spans)
        assert all(s.parent is not None for s in c.spans[1:])
        assert all(s.start_ns >= root.start_ns and s.end_ns <= root.end_ns
                   for s in c.spans)
        steps = c.named("program.step")
        assert all(s.parent == 0 for s in steps)
        # one clique: Z after the (empty) collect pass, then a marginal
        # per variable
        assert [(s.attrs["kind"], s.attrs["at"]) for s in steps] == (
            [("z", None)] + [("marg", v) for v in range(N)])
        assert [s.parent for s in c.named("serve.masks")] == [0]
        assert [s.parent for s in c.named("program.normalize")] == [0]


def test_big_clique_and_k1_spans_carry_their_shapes(routed):
    tree, values, _, masks = routed
    eng = tree.engine(device="cpu", dtype=torch.float32).set_potentials(values)
    (call,), _ = _traced(lambda: eng.posterior_batch(masks))
    routes, k1 = call.named("route.big_clique"), call.named("k1.launch")
    assert len(routes) == len(k1) == N + 1
    for r, k in zip(routes, k1):
        assert call.spans[r.parent].name == "program.step"
        assert call.spans[k.parent] is r
        assert r.attrs == {"states": 2 ** N}
        a = k.attrs
        assert a["R1"] * a["R2"] * a["C"] == 2 ** N
        assert a["B"] == B and a["dtype"] == torch.float32
        assert a["kept"] is None   # nothing is kept off the card
    assert sorted(k.attrs["C"] for k in k1) == [1] + [2] * N


def test_map_spans(routed):
    tree, values, _, masks = routed
    eng = tree.engine("max_product", device="cpu").set_potentials(values)
    (call,), _ = _traced(lambda: eng.map_assignment_batch(_log(masks)))
    assert call.name == "serve.map_assignment_batch"
    assert [s.name for s in call.spans] == [
        "serve.map_assignment_batch", "serve.masks", "map.collect",
        "map.decode"]
    assert all(s.parent == 0 for s in call.spans[1:])
    assert call.named("map.collect")[0].attrs == {"clique": tree.plan.tree.root}


@pytest.mark.parametrize("how", ["chunked", "delegated", "row_sharded"])
def test_a_chunked_delegated_or_sharded_call_is_one_root(routed, how):
    tree, values, _, masks = routed
    eng = tree.engine(device="cpu").set_potentials(values)
    if how == "chunked":
        fn, inner = lambda: eng.posterior_batch(masks, chunk=3), None
    elif how == "delegated":
        fn = lambda: eng.map_assignment_batch(_log(masks))   # noqa: E731
        inner = "serve.map_assignment_batch"
    else:
        eng.shard_batch(make_mesh(2, 1, devices=["cpu"] * 2))
        fn, inner = lambda: eng.posterior_batch(masks), "serve.posterior_batch"
    (call,), _ = _traced(fn)
    if how == "chunked":
        assert len(call.named("program.normalize")) == 3   # ceil(8 / 3)
    else:
        nested = [s for s in call.spans[1:] if s.name == inner]
        assert len(nested) == (1 if how == "delegated" else 2)
        assert all(s.parent == 0 for s in nested)


def test_spans_share_the_profilers_clock(routed):
    """Every span starts and ends within 100 us of the profiler's event of
    the same name: the recorder stamps on kineto's clock."""
    tree, values, _, masks = routed
    eng = tree.engine(device="cpu").set_potentials(values)
    meng = tree.engine("max_product", device="cpu").set_potentials(values)
    calls, events = _traced(lambda: eng.posterior_batch(masks),
                            lambda: meng.map_assignment_batch(_log(masks)))
    spans = [s for c in calls for s in c.spans]
    assert len(spans) > 2 * N
    for s in spans:
        start, end = min(events[s.name], key=lambda e: abs(e[0] - s.start_ns))
        assert abs(start - s.start_ns) < 100_000, s.name
        assert abs(end - s.end_ns) < 100_000, s.name


def test_device_trace_carries_the_spans(routed, tmp_path):
    tree, values, _, masks = routed
    eng = tree.engine(device="cpu").set_potentials(values)
    eng.posterior_batch(masks)
    TIMERS.reset()
    path = tmp_path / "step.json"
    with device_trace(str(path)):
        eng.posterior_batch(masks)
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"serve.posterior_batch", "program.step", "route.big_clique",
            "k1.launch", "serve.masks"} <= names
    assert [c.name for c in TIMERS.calls()] == ["serve.posterior_batch"]


# -- counters ------------------------------------------------------------------

def _route_bytes(n, k, b, itemsize=4):
    """Hand count of the big-clique route's expanded ``w2`` bytes in one
    ``posterior_batch`` of an n-variable binary clique with the first k
    observed: per contraction the observed rest variables split into two
    weight groups (the second takes the smaller half) and ``w2`` spans that
    group and every unobserved rest variable, if any."""
    def w2(rest_observed, rest_unobserved):
        return (b * 2 ** (rest_observed // 2 + rest_unobserved) * itemsize
                if rest_unobserved else 0)
    return (k * w2(k - 1, n - k)                # marginals of observed
            + (n - k) * w2(k, n - k - 1)        # marginals of unobserved
            + w2(k, n - k))                     # Z


def test_route_materialized_bytes_are_the_hand_count(routed):
    tree, values, _, masks = routed
    eng = tree.engine(device="cpu", dtype=torch.float32).set_potentials(values)
    want = _route_bytes(N, OBSERVED, B)
    assert want == B * 4 * (OBSERVED * 2 ** 9 + (N - OBSERVED) * 2 ** 9
                            + 2 ** 10)
    before = TIMERS.counters()["route.materialized_bytes"]
    eng.posterior_batch(masks)       # always counted, traced or not
    assert TIMERS.counters()["route.materialized_bytes"] - before == want
    (call,), _ = _traced(lambda: eng.posterior_batch(masks))
    assert call.counters["route.materialized_bytes"] == want
    assert call.counters["map.materialized_bytes"] == 0


def test_the_benchmark_clique_hand_count():
    """The 2^18-state clique with 12 of 18 observed: 18 marginals at R2 =
    2,048 and Z at 4,096."""
    assert _route_bytes(18, 12, 262144) == (18 * 2 + 4) * 2 ** 30


@pytest.mark.parametrize("observed", [0, 1, 3])
def test_map_materialized_bytes_are_the_hand_count(routed, observed):
    """One clique: its masked scores are one new [B, 2^n] tensor (the first
    mask's add; the others add in place); [1, 2^n] without evidence (the
    program's one all-zeros row on variable 0)."""
    tree, values, names, _ = routed
    eng = tree.engine("max_product", device="cpu").set_potentials(values)
    masks = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, B, names[:observed], seed=4)) if observed else {}
    before = TIMERS.counters()["map.materialized_bytes"]
    eng.map_assignment_batch(_log(masks))
    want = (B if observed else 1) * 2 ** N * _itemsize(eng)
    assert TIMERS.counters()["map.materialized_bytes"] - before == want


def test_map_counts_the_permuted_copy():
    """Two cliques: the child's (sep, rest) permute of its [B, clique]
    scores copies where its separator is not its leading axis."""
    rng = np.random.default_rng(5)
    sizes = {"a": 2, "b": 3, "c": 4}
    tree = jt.create_junction_tree([["a", "b"], ["b", "c"]], sizes)
    values = [rng.random((2, 3)) + 0.1, rng.random((3, 4)) + 0.1]
    eng = tree.engine("max_product", device="cpu").set_potentials(values)
    masks = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, B, ["a", "c"], seed=6))
    plan, size = tree.plan, _itemsize(eng)
    want = 0
    for c in plan.tree.topo_order:
        cv = plan.clique_vars[c]
        full = B * int(np.prod([sizes[plan.table.label_of(v)] for v in cv]))
        want += full * size                    # its masked scores
        if c != plan.tree.root:
            sep = plan.sep_vars[plan.tree.parent_sep[c]]
            if list(cv[:len(sep)]) != list(sep):
                want += full * size            # the permuted copy
    before = TIMERS.counters()["map.materialized_bytes"]
    eng.map_assignment_batch(_log(masks))
    assert TIMERS.counters()["map.materialized_bytes"] - before == want


def test_mask_bytes_count_what_leaves_the_host():
    """``serve.mask_bytes``: the masks placed from the host on another
    device (a meta engine here); none on a CPU engine."""
    tree, values, names = _big_clique(4)
    masks = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, B, names[:3], seed=1))
    for device, n in (("cpu", 0), ("meta", 3 * B * 2)):
        eng = tree.engine(device=device).set_potentials(values)
        before = TIMERS.counters()["serve.mask_bytes"]
        eng.posterior_batch(masks)
        assert TIMERS.counters()["serve.mask_bytes"] - before == \
            n * _itemsize(eng)


def test_program_build_is_counted_once_per_key(routed):
    tree, values, names, masks = routed
    TIMERS.reset()
    eng = tree.engine(device="cpu").set_potentials(values)
    other = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, B, names[2:5], seed=2))
    for m in (masks, masks, other, masks):
        eng.posterior_batch(m)
    assert TIMERS.counts["program.build"] == 2 == len(eng._programs)
    for m in (masks, other, other):
        eng.map_assignment_batch(_log(m))
    assert TIMERS.counts["program.build"] == 4
    assert TIMERS.counts["engine.upload"] == 2   # the engine and its MAP twin
    assert TIMERS.totals["engine.upload"] > 0


def test_kept_evictions_count_the_remakes():
    """One kept layout, two alternating: a new layout serves its call alone
    until more than one miss has passed since the kept one was used, then
    puts it out; each such eviction is a layout made again later."""
    pot = torch.rand((2, 3, 2))
    fc.standing(pot, 1)
    made = []

    def look(key):
        fc.kept(pot, (key,), lambda: made.append(key) or fc.Operand(pot, 0))

    before = TIMERS.counters()
    for key in "ABBAABB":
        look(key)
    after = TIMERS.counters()
    assert made == list("ABBAABB")
    assert after["kept.misses"] - before["kept.misses"] == 7
    assert after["kept.evictions"] - before["kept.evictions"] == 3
    assert TIMERS.counts["k1.split"] >= 7


def test_counters_is_one_table_of_every_counter(routed):
    tree, values, _, masks = routed
    eng = tree.engine(device="cpu").set_potentials(values)
    before = TIMERS.counters()
    eng.posterior_batch(masks)
    table = TIMERS.counters()
    assert set(table) == set(timing.COUNTERS)
    assert table["big_clique_sep_message.calls"] \
        > before["big_clique_sep_message.calls"]
    assert table["factored_masked_contract.launches"] \
        == before["factored_masked_contract.launches"]  # none on the CPU
    d = eng.describe()
    assert set(d["counters"]) == set(table)
    assert {"kernel_launches", "kept_layouts",
            "process_phase_totals_s"} <= set(d)


def test_one_counter_mechanism(routed):
    """The recorder imports no kernel module; every counter of the table
    is one of ``COUNTERS``; ``describe()["kernel_launches"]`` reads the
    same counters."""
    import ast
    import inspect

    src = ast.parse(inspect.getsource(timing))
    imported = [n.module or "" for n in ast.walk(src)
                if isinstance(n, ast.ImportFrom)] + [
        a.name for n in ast.walk(src) if isinstance(n, ast.Import)
        for a in n.names]
    assert not [m for m in imported if "ops" in m.split(".")]
    assert set(TIMERS.counters()) <= set(timing.COUNTERS)
    tree, values, _, masks = routed
    eng = tree.engine(device="cpu").set_potentials(values)
    eng.posterior_batch(masks)
    d = eng.describe()
    c = d["counters"]
    assert d["kernel_launches"] == {
        "factored_masked_contract": c["factored_masked_contract.launches"],
        "factored_masked_contract_bf16":
            c["factored_masked_contract.launches_bf16"],
        "factored_masked_contract_backward":
            c["factored_masked_contract.launches_backward"],
        "big_clique_route_calls": c["big_clique_sep_message.calls"],
    }


# -- the general program's planned contractions and the compile ladder --------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_planned_einsum_spans_carry_their_shapes(dtype):
    """One clique over a (2 states) and b (3), evidence on a, B = 4: the
    belief, Z and the two marginals, each with its batch, the states of the
    union of its operands' scopes and their bytes plus the output's."""
    tree = jt.create_junction_tree([["a", "b"]], {"a": 2, "b": 3})
    eng = tree.engine(device="cpu", dtype=dtype).set_potentials(
        [np.arange(1.0, 7.0).reshape(2, 3)])
    masks = {"a": np.ones((4, 2), np.float32)}
    before = TIMERS.counters()["route.einsum_calls"]
    (call,), _ = _traced(lambda: eng.posterior_batch(masks))
    spans = call.named("route.einsum")
    w = _itemsize(eng)
    bel = 4 * 6 * w
    assert [s.attrs for s in spans] == [
        {"B": 4, "states": 6, "bytes": 6 * w + 4 * 2 * w + bel},  # belief
        {"B": 4, "states": 6, "bytes": bel + 4 * w},              # Z
        {"B": 4, "states": 6, "bytes": bel + 4 * 2 * w},          # P(a)
        {"B": 4, "states": 6, "bytes": bel + 4 * 3 * w},          # P(b)
    ]
    assert all(call.spans[s.parent].name == "program.step" for s in spans)
    assert call.counters["route.einsum_calls"] == 4
    # two calls ran (the warm one and the traced one)
    assert TIMERS.counters()["route.einsum_calls"] == before + 8


def test_einsum_calls_and_refusals_count_what_they_say(monkeypatch):
    """On a 5 x 5 spin glass with the route's threshold lowered to 2^4:
    every planned contraction is counted, and so is every contraction of a
    clique of 2^4 states or more with batched operands that fell to it
    (the route refused it)."""
    from junctiontree_tpu_torch import executor
    from junctiontree_tpu_torch.models import ising_grid_model

    monkeypatch.setattr(jt.config.DEFAULT, "big_clique_min_states", 1 << 4)
    factors, sizes, values = ising_grid_model(5, 5, 10.0, seed=1)
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu").set_potentials(values)
    masks = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, 6, list(sizes)[::3], seed=2))
    eng.posterior_batch(masks)     # the program is built outside the count
    seen = {"calls": 0, "refused": 0}
    inner = executor._bcontract

    def spy(semiring, ops, ovs, out):
        seen["calls"] += 1
        scope = {v for vs in ovs if not (vs and vs[0] == executor.BATCH)
                 for v in vs}
        batched = any(vs and vs[0] == executor.BATCH for vs in ovs)
        if scope and batched and math.prod(
                tree.plan.sizes[v] for v in scope) >= 1 << 4:
            seen["refused"] += 1
        return inner(semiring, ops, ovs, out)

    monkeypatch.setattr(executor, "_bcontract", spy)
    before = TIMERS.counters()
    eng.posterior_batch(masks)
    after = TIMERS.counters()
    assert after["route.einsum_calls"] - before["route.einsum_calls"] \
        == seen["calls"] > 0
    assert after["big_clique_sep_message.refused"] \
        - before["big_clique_sep_message.refused"] == seen["refused"] > 0
    assert after["big_clique_sep_message.calls"] \
        > before["big_clique_sep_message.calls"]


def test_compile_escalations_count_and_name_the_winner(monkeypatch):
    """A 10 x 10 lattice's min-fill plan holds 2^14 states; with the
    threshold at 2^11 the compile escalates once, the portfolio runs as it
    always did, and the bandwidth order (2^11 states) beats it.  Under the
    default threshold nothing escalates."""
    from junctiontree_tpu_torch import triangulate
    from junctiontree_tpu_torch.models import ising_grid_model

    factors, sizes, _ = ising_grid_model(10, 10, 10.0)
    n = TIMERS.counters()["compile.escalations"]
    plan = jt.compile_plan(factors, sizes)
    assert TIMERS.counters()["compile.escalations"] == n
    assert plan.stats()["order"] == "min_fill"
    assert plan.stats()["max_clique_states"] == 1 << 14

    ran = []
    inner = triangulate.portfolio_triangulation

    def spy(*a, **k):
        ran.append(k.get("random_restarts"))
        return inner(*a, **k)

    monkeypatch.setattr(triangulate, "portfolio_triangulation", spy)
    monkeypatch.setattr(jt.config.DEFAULT, "escalate_min_states", 1 << 11)
    plan = jt.compile_plan(factors, sizes)
    assert ran[0] == 16  # annealing then seeds from a portfolio of its own
    assert TIMERS.counters()["compile.escalations"] == n + 1
    assert plan.stats()["order"] == "bandwidth"
    assert plan.stats()["max_clique_states"] == 1 << 11
    assert jt.compile_plan(factors, sizes, heuristic="min_degree").stats()[
        "order"] == "min_degree"
    assert TIMERS.counters()["compile.escalations"] == n + 1
