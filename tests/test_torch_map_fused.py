"""The tree-MAP program's fused max-plus collect (``ops.map_collect``,
kernel ``csrc/map_collect.cu``) against the plain collect
(``map_executor._collect_plain``).

On the CPU (tier 1): the host side of the kernel.  The wrapper's offset
table and addend strides are read by ``map_collect.reference_collect``, a
plain-PyTorch emulation of the kernel's indexing, which the tree-MAP
program takes for float32 CPU cliques once the engagement predicate is
patched; its scores and assignments must equal the plain program's on the
MAP test models.  The predicate itself, the launch configuration and the
counters are checked as they stand.

On the card (marked ``cuda``, skipped elsewhere): the kernel against the
plain path, scores bit for bit, assignments equal (both take the lowest
index among equal maxima), every assignment attaining its score, and
repeated runs equal.  Imports no JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_map_fused.py
"""

import threading

import numpy as np
import pytest
import torch

import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch import map_executor
from junctiontree_tpu_torch.map_executor import tree_map_program
from junctiontree_tpu_torch.models import chain_bn_model, grid_mrf_model
from junctiontree_tpu_torch.ops import map_collect
from junctiontree_tpu_torch.utils.timing import TIMERS

from .util import grid_mrf, random_factor_graph, random_values

FUSED = ("map.fused_cliques", "map.fused_states")


def _emulate(monkeypatch):
    """Float32 cliques on any device go to ``map_collect.collect``, whose
    plain version runs on the CPU."""
    monkeypatch.setattr(map_collect, "engages",
                        lambda dtype, device: dtype == torch.float32)


def _plain(monkeypatch):
    monkeypatch.setattr(map_collect, "engages", lambda dtype, device: False)


def _big_clique(n=18, seed=0):
    """One dense factor over n binary variables plus unaries: a single
    2^n-state clique (the benchmark's configuration at n = 18)."""
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(n)]
    factors = [names[:]] + [[v] for v in names]
    values = [rng.random((2,) * n) + 0.1] + [rng.random(2) + 0.1
                                               for _ in names]
    return factors, {v: 2 for v in names}, values


def _hub(n=40, seed=0):
    """A three-state hub with n binary leaves: a root clique with n - 1
    children, past the launch's arguments' 32 addends."""
    names = [f"x{i}" for i in range(n)]
    factors = [["h", x] for x in names] + [["h"]]
    sizes = {"h": 3, **{x: 2 for x in names}}
    return factors, sizes, random_values(factors, sizes, seed=seed)


def _wide(seed=0):
    """Masks of many states: a 600-state variable whose mask stages for
    64 rows only in more than the default 48 KB of shared memory, and a
    2,000-state one that does not stage at all (read from global memory),
    after a small mask of its clique that does."""
    factors = [["a", "w"], ["b", "w", "z"], ["z", "v"], ["v"]]
    sizes = {"b": 3, "w": 2000, "z": 2, "a": 3, "v": 600}
    return factors, sizes, random_values(factors, sizes, seed=seed)


def _stacked_cliques(card=2, seed=0):
    """Three overlapping cliques of five variables (separators of three):
    non-root cliques with children's messages over several variables."""
    names = [f"s{i}" for i in range(9)]
    factors = [names[0:5], names[2:7], names[4:9], [names[8]]]
    sizes = {v: card for v in names}
    return factors, sizes, random_values(factors, sizes, seed=seed)


def model(name):
    """(factors, sizes, values, observed labels) of a test model."""
    if name.startswith("grid"):
        card = int(name[4:] or 2)
        f, s, v = grid_mrf_model(4, 4, card=card, seed=9)
        return f, s, v, ["g0_0", "g1_2", "g3_3", "g2_1"]
    if name == "chain":
        f, s, v = chain_bn_model(16, card=3, seed=9)
        return f, s, v, ["x0", "x7", "x15"]
    if name.startswith("random"):
        f, s = random_factor_graph(int(name[6:]) + 200, n_vars=7,
                                   n_factors=9, max_card=4)
        return f, s, random_values(f, s, seed=int(name[6:])), ["v1", "v4"]
    if name == "ties":
        f, s = grid_mrf(3, 3)
        return f, s, [np.ones([s[x] for x in fac]) for fac in f], ["g0_0"]
    if name == "neg_inf":
        f, s = grid_mrf(3, 3, card=3)
        v = random_values(f, s, seed=4)
        for x in v[1::3]:
            x[0] = 0.0  # log 0 = -inf in the max-product potentials
        return f, s, v, ["g1_1", "g2_2"]
    if name == "evidence_free":
        f, s, v = grid_mrf_model(3, 4, seed=2)
        return f, s, v, ["g0_0"]  # the far cliques stay unbatched
    if name.startswith("stacked"):
        f, s, v = _stacked_cliques(card=int(name[7:] or 2))
        return f, s, v, ["s0", "s5", "s8"]
    if name == "bigclique":
        f, s, v = _big_clique(n=10)
        return f, s, v, [f"v{i}" for i in range(6)]
    if name == "hub":
        f, s, v = _hub()
        return f, s, v, ["h", "x0", "x3", "x39"]
    if name == "wide":
        f, s, v = _wide()
        return f, s, v, ["b", "w", "z", "a", "v"]
    raise KeyError(name)


def _masks(sizes, labels, B, seed, soft=True):
    """Log masks: one-hot (0 / -inf) rows, soft rows (log of random
    weights) and row 0 impossible (every state forbidden on the first
    label)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, lab in enumerate(labels):
        n = sizes[lab]
        m = np.full((B, n), -np.inf, dtype=np.float32)
        m[np.arange(B), rng.integers(0, n, B)] = 0.0
        if soft:
            m[1::3] = np.log(rng.random((len(m[1::3]), n)) + 0.05)
        if k == 0:
            m[0] = -np.inf
        out[lab] = m
    return out


def _run(eng, masks):
    """The tree-MAP program of ``eng`` (a max-product engine) on ``masks``:
    (assign, score) and the change in the fused counters."""
    before = TIMERS.counters()
    assign, score = tree_map_program(eng.plan, _ids(eng, masks))(
        eng._pots, [torch.as_tensor(masks[k], device=eng.device)
                    for k in _labels(eng, masks)])
    after = TIMERS.counters()
    return assign, score, {k: after[k] - before[k]
                           for k in FUSED + ("map.materialized_bytes",)}


def _labels(eng, masks):
    return sorted(masks, key=eng.plan.table.id_of)


def _ids(eng, masks):
    return [eng.plan.table.id_of(k) for k in _labels(eng, masks)]


def _engine(f, s, v, device="cpu"):
    return jt.create_junction_tree(f, s).engine(
        "max_product", device=device, dtype=torch.float32).set_potentials(v)


# ---------------------------------------------------------------- CPU tests


@pytest.mark.parametrize("dtype,device,want", [
    (torch.float32, "cuda", True),
    (torch.float64, "cuda", False),
    (torch.bfloat16, "cuda", False),
    (torch.float16, "cuda", False),
    (torch.float32, "cpu", False),
    (torch.float32, "meta", False),
])
def test_engages_float32_on_cuda_only(dtype, device, want):
    """The kernel's engagement rule: float32 on a CUDA device (asked of the
    dtype and device alone, so no card is needed here)."""
    assert map_collect.engages(dtype, torch.device(device)) is want


@pytest.mark.parametrize("name", ["grid3", "stacked", "random1", "bigclique",
                                  "hub", "wide"])
def test_step_offsets_hold_at_every_step(name):
    """Each clique's step of ``group`` states (the innermost axes of its
    rest) has the same offsets from its first state at every step, in every
    row of the table: what the kernel reads instead of the table for the
    step's later states."""
    f, s, v, labels = model(name)
    plan = _engine(f, s, v).plan
    cmv = map_executor.clique_mask_vars(
        plan, [plan.table.id_of(k) for k in labels])
    layouts = map_executor._fused_layouts(plan, cmv,
                                          map_executor._layout(plan)).values()
    assert max(fl.group for fl in layouts) > 1
    for fl in layouts:
        tab = fl.table_np()
        inner = fl.inner_np(tab)
        assert fl.rest_n % fl.group == 0 and fl.group in map_collect.GROUPS
        steps = tab.reshape(tab.shape[0], -1, fl.group)
        assert np.array_equal(steps - steps[:, :, :1], np.broadcast_to(
            inner[:, None, :], steps.shape))


def test_table_by_hand():
    """A clique (a, b, c) of sizes (2, 3, 2) with separator (c, a) to its
    parent, a mask on b then one on a, and a child's message over (b, c):
    state v = (c, a, b) in the traceback's (sep, rest) order."""
    sizes = [2, 3, 2]  # a, b, c = 0, 1, 2
    lay = map_collect.CliqueLayout(sizes, [0, 1, 2], [2, 0, 1], 4, [1, 0],
                                   [[1, 2]])
    assert (lay.states, lay.out_n, lay.rest_n, lay.mask_sizes) == (12, 4, 3,
                                                                   [3, 2])
    tab = lay.table_np()
    assert tab.dtype == np.int32 and tab.shape == (4, 12)
    for v in range(12):
        c, a, b = v // 6, (v // 3) % 2, v % 3
        assert tab[0, v] == a * 6 + b * 2 + c     # potential, (a, b, c)
        assert tab[1, v] == b                     # mask on b: rows 0-2
        assert tab[2, v] == 3 + a                 # mask on a: rows 3-4
        assert tab[3, v] == b * 2 + c             # child's (b, c) state


@pytest.mark.parametrize("name", [
    "grid", "grid3", "grid5", "chain", "random0", "random1", "random2",
    "random3", "ties", "neg_inf", "evidence_free", "stacked", "stacked3",
    "bigclique", "hub", "wide"])
def test_emulation_equals_plain_program(monkeypatch, name):
    """The wrapper's tables and strides, read by the kernel's plain
    emulation, give the plain program's scores and assignments exactly
    (float32, CPU), and no [b, clique] tensor is counted for them."""
    f, s, v, labels = model(name)
    eng = _engine(f, s, v)
    masks = _masks(s, labels, B=7, seed=len(name))
    a_plain, s_plain, c_plain = _run(eng, masks)
    assert c_plain["map.fused_cliques"] == 0
    _emulate(monkeypatch)
    a_fused, s_fused, c_fused = _run(eng, masks)
    assert torch.equal(s_fused, s_plain) and torch.equal(a_fused, a_plain)
    assert a_fused.dtype == torch.int32
    ncl = len(eng.plan.clique_vars)
    assert c_fused["map.fused_cliques"] == ncl
    assert c_fused["map.materialized_bytes"] == 0
    assert c_fused["map.fused_states"] <= 7 * sum(
        int(np.prod([eng.plan.sizes[x] for x in cv]))
        for cv in eng.plan.clique_vars)
    assert -1.1e30 < float(s_fused[0]) < -1e29


def test_emulation_keeps_evidence_free_cliques_unbatched(monkeypatch):
    """A clique with no evidence below it is collected with b = 1: the
    fused states count one row for it."""
    f, s, v, labels = model("evidence_free")
    eng = _engine(f, s, v)
    _emulate(monkeypatch)
    B = 5
    _, _, c = _run(eng, _masks(s, labels, B=B, seed=1))
    full = B * sum(int(np.prod([eng.plan.sizes[x] for x in cv]))
                   for cv in eng.plan.clique_vars)
    assert c["map.fused_states"] < full


def test_emulation_with_ties_takes_the_lowest_index(monkeypatch):
    """Uniform potentials and zero masks: every state ties, so every
    clique's argmax is its first state and the assignment is all zeros."""
    f, s = grid_mrf(3, 3, card=3)
    eng = _engine(f, s, [np.ones([s[x] for x in fac]) for fac in f])
    _emulate(monkeypatch)
    masks = {"g1_1": np.zeros((4, 3), dtype=np.float32)}
    assign, score, _ = _run(eng, masks)
    assert torch.equal(score, torch.zeros(4))
    assert int(assign.abs().sum()) == 0


def test_emulation_chunked_equals_plain_unchunked(monkeypatch):
    """``map_assignment_batch(chunk=)`` through the emulated collect equals
    the plain unchunked call."""
    f, s, v, labels = model("grid")
    eng = _engine(f, s, v)
    masks = _masks(s, labels, B=7, seed=3)
    a_want, s_want = eng.map_assignment_batch(masks)
    _emulate(monkeypatch)
    before = TIMERS.counters()["map.fused_cliques"]
    a_got, s_got = eng.map_assignment_batch(masks, chunk=3)
    assert TIMERS.counters()["map.fused_cliques"] - before == 3 * len(
        eng.plan.clique_vars)
    assert torch.equal(s_got, s_want) and torch.equal(a_got, a_want)


@pytest.mark.parametrize("name,n_staged", [
    ("hub", 0), ("hub", 1), ("wide", 0), ("wide", 1)])
def test_descriptors(name, n_staged):
    """The addends as the kernel reads them: 48 bytes each, masks (with
    their sizes) before messages, the step's offsets, the CPU tensors'
    pointers and strides.  A mask past the ``n_staged`` staged ones points
    its prefix earlier, so that its table offset, the staged row (its
    prefix plus its state), reads its own state."""
    assert map_collect.ADDEND_DTYPE.itemsize == 48
    f, s, v, labels = model(name)
    eng = _engine(f, s, v)
    plan = eng.plan
    masks = _masks(s, labels, B=5, seed=2)
    ids = _ids(eng, masks)
    placed = dict(zip(ids, (torch.as_tensor(masks[k])
                            for k in _labels(eng, masks))))
    cmv = map_executor.clique_mask_vars(plan, ids)
    seen = 0
    for fl in map_executor._fused_layouts(
            plan, cmv, map_executor._layout(plan)).values():
        nm = len(fl.mask_vars)
        tab = fl.table(torch.device("cpu")).numpy()
        msgs = [torch.zeros((5, int(np.prod([plan.sizes[x] for x in sep]))))
                for sep in fl.child_seps]
        adds = map_collect.addends(fl, [placed[x] for x in fl.mask_vars],
                                   msgs)
        d = map_collect.descriptors(fl, adds, min(n_staged, nm))
        assert len(d) == fl.n_addends == nm + len(msgs)
        assert list(d["size"]) == fl.mask_sizes + [0] * len(msgs)
        inner = fl.inner_np(tab)[1:]
        assert np.array_equal(d["inner"][:, :fl.group], inner)
        assert list(d["vary"]) == [int((r != 0).any()) for r in inner]
        for i, a in enumerate(adds):
            assert (d["bstride"][i], d["ostride"][i]) == (a.bstride, a.ostride)
            if min(n_staged, nm) <= i < nm:
                prefix = sum(fl.mask_sizes[:i])
                assert tab[1 + i].min() == prefix
                assert tab[1 + i].max() == prefix + a.size - 1
                assert int(d["ptr"][i]) + 4 * prefix * a.ostride == (
                    a.t.data_ptr())
                seen += 1
            else:
                assert int(d["ptr"][i]) == a.t.data_ptr()
    assert seen > 0


def test_hub_and_wide_reach_past_the_default_limits():
    """The card tests' "hub" and "wide" models at their B = 300 take the
    kernel past its common case: more addends than the launch's arguments
    hold, masks staged in more than the default 48 KB of shared memory, and
    a mask read from global memory after a staged one."""
    seen = set()
    for name in ("hub", "wide"):
        f, s, v, labels = model(name)
        eng = _engine(f, s, v)
        plan = eng.plan
        cmv = map_executor.clique_mask_vars(
            plan, [plan.table.id_of(k) for k in sorted(
                labels, key=plan.table.id_of)])
        for fl in map_executor._fused_layouts(
                plan, cmv, map_executor._layout(plan)).values():
            cfg = map_collect.launch_config(300, fl.states, fl.mask_sizes,
                                            fl.n_addends, fl.group, 132)
            if fl.n_addends > map_collect.ARG_ADDENDS:
                seen.add("addends past the arguments")
            if map_collect.smem_bytes(sum(fl.mask_sizes[:cfg.n_staged]),
                                      fl.n_addends, cfg.rpt) > 48 * 1024:
                seen.add("opt-in shared memory")
            if 0 < cfg.n_staged < len(fl.mask_sizes):
                seen.add("a global mask after a staged one")
    assert len(seen) == 3, seen


def test_counters_stay_at_zero_on_the_cpu():
    """On the CPU the program keeps the plain collect: no clique is fused,
    and its [b, clique] tensors are counted as before."""
    f, s, v, labels = model("grid")
    eng = _engine(f, s, v)
    before = TIMERS.counters()
    eng.map_assignment_batch(_masks(s, labels, B=4, seed=2))
    after = eng.describe()["counters"]
    assert all(after[k] == before[k] for k in FUSED)
    assert after["map.materialized_bytes"] > before["map.materialized_bytes"]


@pytest.mark.parametrize("name,fused,want", [
    ("grid", False, 1.7), ("grid", True, 0.0), ("chain", True, 1.7)])
def test_max_feasible_batch_counts_no_clique_rows_where_fused(
        monkeypatch, name, fused, want):
    """``max_feasible_batch(task="map")`` reckons no [B, clique] tensor a
    row, but the largest separator's 8-byte keys, where the fused collect
    takes the tree-MAP program's cliques (float32 on the card; here the
    predicate is patched), and the plain program's rows elsewhere, also
    for a chain's Viterbi loop; posteriors as before."""
    f, s, v, _ = model(name)
    eng = _engine(f, s, v)
    if fused:
        _emulate(monkeypatch)
    st = eng.plan.stats()
    seps = sum(int(np.prod([eng.plan.sizes[x] for x in sv]))
               for sv in eng.plan.tree.separators)
    keys = 8 * st["max_sep_states"] if fused and name != "chain" else 0
    for task, cliques, extra in (("map", want, keys), ("posterior", 2.6, 0)):
        row = 4 * int(cliques * st["max_clique_states"] + 2 * seps) + extra
        b = ((1 << 24) - 4 * st["total_clique_states"]) // row
        assert eng.max_feasible_batch(1 << 24, task=task) == 1 << (
            b.bit_length() - 1)


@pytest.mark.parametrize("b,states,mask_sizes,k,group,want", [
    # the benchmark's MAP cell: the root split over 66 blocks a row tile
    (4096, 2**18, [2] * 12, 12, 4, (4, 12, 500, 66)),
    (1, 2**18, [], 0, 4, (1, 0, 32, 1024)),            # an unbatched root
    (40, 512, [2], 1, 2, (2, 1, 32, 2)),               # 33-64 rows: 2 a lane
    # the 8x8 grid's cliques of 2^11 states over 2^10 separator states
    (4096, 2048, [2], 3, 2, (4, 1, 32, 8)),
    # 150 mask states stage for 128 rows in 83 KB (opt-in shared memory)
    (4096, 2**18, [50, 50, 50], 5, 4, (4, 3, 500, 66)),
    (4096, 2**18, [600], 1, 4, (2, 1, 996, 33)),       # 2 rows a lane fit
    # a 2,000-state mask stages for no row tile: read from global memory
    (4096, 6000, [3, 2000], 2, 1, (1, 1, 45, 17)),
    (4096, 2**18, [2, 2], 40, 4, (4, 2, 500, 66)),     # 40 addends
    (4096, 2**18, [2] * 36, 36, 4, (4, 32, 500, 66)),  # 32 staged at most
])
def test_launch_config(b, states, mask_sizes, k, group, want):
    got = map_collect.launch_config(b, states, mask_sizes, k, group,
                                    sm_count=132)
    assert tuple(got) == want
    n = got.n_staged
    assert (map_collect.smem_bytes(sum(mask_sizes[:n]), k, got.rpt)
            <= map_collect.SMEM_BYTES)
    if n < min(len(mask_sizes), map_collect.ARG_ADDENDS):
        assert got.rpt == 1 and map_collect.smem_bytes(
            sum(mask_sizes[:n + 1]), k, 1) > map_collect.SMEM_BYTES
    assert got.nsplit <= 65535 and got.nsplit * 8 * got.wchunk >= states
    assert got.wchunk % group == 0


# ---------------------------------------------------------------- card tests


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _bits_equal(x, y):
    return x.shape == y.shape and torch.equal(x.view(torch.int32),
                                              y.view(torch.int32))


def _card_pair(monkeypatch, eng, masks):
    """(fused, plain) runs of the program on the card."""
    fused = _run(eng, masks)
    with monkeypatch.context() as m:
        _plain(m)
        plain = _run(eng, masks)
    torch.cuda.synchronize()
    return fused, plain


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "grid", "grid3", "grid5", "random0", "random1", "random2", "ties",
    "neg_inf", "evidence_free", "stacked", "stacked3", "stacked5",
    "bigclique", "hub", "wide"])
def test_kernel_equals_plain_program(cuda, monkeypatch, name):
    """Scores bit for bit, the same assignments (both paths take the lowest
    index among equal maxima), each attaining its score; cards 2, 3 and 5,
    separators of three variables, unbatched cliques, -inf potentials,
    ties, an impossible row, a root of 41 addends, and masks staged past
    48 KB of shared memory or read from global memory."""
    f, s, v, labels = model(name)
    eng = _engine(f, s, v, device=cuda)
    masks = _masks(s, labels, B=300, seed=len(name))
    (a_f, s_f, c_f), (a_p, s_p, c_p) = _card_pair(monkeypatch, eng, masks)
    assert c_f["map.fused_cliques"] == len(eng.plan.clique_vars)
    assert c_f["map.materialized_bytes"] == 0 and c_p["map.fused_cliques"] == 0
    assert _bits_equal(s_f, s_p)
    assert torch.equal(a_f, a_p)
    assert -1.1e30 < float(s_f[0]) < -1e29 and not torch.isnan(s_f).any()
    lab = eng.plan.table.label_of
    a_host = a_f.cpu().numpy()
    logm = {k: m.astype(np.float64) for k, m in masks.items()}
    for b in range(1, 12):
        if float(s_f[b]) < -1e29:
            continue  # no feasible assignment
        own = eng.score_assignment(
            {lab(x): int(a_host[b, x]) for x in range(a_host.shape[1])})
        own += sum(float(logm[k][b, a_host[b, eng.plan.table.id_of(k)]])
                   for k in masks)
        assert abs(own - float(s_f[b])) <= 1e-4 * max(1.0, abs(own))


@pytest.mark.cuda
def test_kernel_at_the_benchmark_shape(cuda, monkeypatch):
    """The MAP cell's shape at the collect: one 2^18-state root clique,
    B = 4,096, twelve masks (one-hot, soft, row 0 impossible).  Scores bit
    for bit; each index is the lowest that attains its row's maximum in the
    plain path's own [b, 2^18] sum."""
    f, s, v = _big_clique(18)
    eng = _engine(f, s, v, device=cuda)
    masks = _masks(s, [f"v{i}" for i in range(12)], B=4096, seed=7)
    (a_f, s_f, c_f), (a_p, s_p, _) = _card_pair(monkeypatch, eng, masks)
    assert c_f["map.fused_cliques"] == 1
    assert c_f["map.fused_states"] == 4096 * 2**18
    assert _bits_equal(s_f, s_p) and torch.equal(a_f, a_p)
    plan = eng.plan
    ids = _ids(eng, masks)
    cmv = map_executor.clique_mask_vars(plan, ids)
    placed = [torch.as_tensor(masks[k], device=cuda)
              for k in _labels(eng, masks)]
    slot = {x: i for i, x in enumerate(ids)}
    score, idx = map_executor._collect_plain(plan, 0, eng._pots, placed,
                                             slot, cmv[0], [], None)
    fl = map_collect.CliqueLayout(plan.sizes, plan.clique_vars[0],
                                  plan.clique_vars[0], 1, cmv[0], [])
    vals, fidx = map_collect.collect(fl, eng._pots[0],
                                     [placed[slot[x]] for x in cmv[0]], [])
    bel = map_executor._masked_potential(plan, 0, eng._pots, placed, slot,
                                         cmv[0]).reshape(4096, -1)
    lowest = (bel == bel.max(dim=-1, keepdim=True).values).int().argmax(-1)
    del bel
    assert _bits_equal(vals[0], score)
    assert torch.equal(fidx[0].long(), lowest) and torch.equal(idx, lowest)


@pytest.mark.cuda
def test_kernel_is_repeatable(cuda):
    """Twenty runs, and runs on two streams at once, give the same bits."""
    f, s, v, labels = model("stacked3")
    eng = _engine(f, s, v, device=cuda)
    masks = _masks(s, labels, B=4096, seed=11)
    a0, s0, _ = _run(eng, masks)
    for _ in range(19):
        a, sc, _ = _run(eng, masks)
        assert _bits_equal(sc, s0) and torch.equal(a, a0)
    out = [None, None]

    def work(k):
        st = torch.cuda.Stream(device=cuda)
        with torch.cuda.stream(st):
            out[k] = _run(eng, masks)[:2]
        st.synchronize()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for a, sc in out:
        assert _bits_equal(sc, s0) and torch.equal(a, a0)
