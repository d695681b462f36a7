"""Smoke run of junctiontree_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the CUDA kernel from the sources in this checkout (and checks in
its SASS that every bfloat16 kernel runs ``wgmma`` fed by the Tensor Memory
Accelerator), holds it against its plain PyTorch version at the shapes the
serving path gives it and at one model shard of each (with its time beside
the plain version's, one PyTorch ``einsum`` call's, the two library
products of ``library_factored_contract`` and the card's bound) and at edge
shapes, then serves evidence batches through the public entry points
(``create_junction_tree(...).engine(...).set_potentials(...)
.posterior_batch(masks)``), one phase per path.  No serving path may copy a
bfloat16 operand into an aligned buffer for the Tensor Memory Accelerator
(phase ``tma_copies``).

Right after the kernel's phases come the surface around the engine:

* ``autotune``: ``ops/autotune.py`` times the kernel against the library on
  each shape of the big clique's ``posterior_batch`` in float32 and
  bfloat16 (a diagnostic), then that call runs in both dtypes with the
  table filled, every contraction still launching the kernel, held to
  float64;
* ``precision``: ``hailfinder_like()`` with TF32 allowed by the caller,
  held to float64, the caller's setting kept;
* ``native_compile``: the 1,000-leaf star and the 5,000-chain planned by
  the Python and the C++ compiler, the plans equal;
* ``cli``: ``python -m junctiontree_tpu_torch`` in process on the big clique
  written as a UAI file, MAR and PR held to float64;
* ``memory_estimates``: ``max_feasible_batch`` for posteriors and tree-MAP
  within an 8 GiB budget at the batch it returns and above it at twice
  that, and the cutset engine's chunks within 1.25 x its budget.

Every phase runs with the package's defaults, under which each big-clique
contraction on the card launches the kernel; then:

* ``big_clique_serving``: the single 2^18-state clique (18 binary variables,
  one dense factor plus 18 unaries, evidence on 12), B = 4096, float32:
  every big contraction runs the kernel;
* ``bf16_serving``: the same with ``dtype=torch.bfloat16``: the kernel's
  bf16 variant, held to the float32 engine;
* ``classic_serving``: ``hailfinder_like()`` (56 variables, largest clique
  12.4M states), B = 128, evidence on every third variable: the
  planned-einsum route at the size of the largest in-repo network;
* ``log_serving``: the same model on the ``LOG_SUM_EXP`` engine (the
  log-matmul-exp branch), held to the sum-product engine, and one
  ``MAX_PRODUCT`` posterior on the sprinkler network;
* ``chain_serving``: a 5,000-variable chain, B = 1024, auto mode (the
  forward-backward program), held to float64 and to ``mode="general"``;
* ``chain_step_kernel``: the chain program's step (the library's product
  and the row kernel) at the HMM cell's shape ([16384, 500] x [500, 500]
  float32) against the plain step (the product and ``reference_rows``),
  the library's product alone and the FP32 bound, and one HMM
  ``posterior_batch`` at the cell's shape through it, its launches
  counted, against the plain steps;
* ``fused_serving``: a 1,000-leaf star, B = 1024, auto mode (the level-fused
  program), and the 8x8 grid, B = 4096, ``mode="fused"`` against
  ``mode="general"``;
* ``chunked_serving``: ``hailfinder_like()`` B = 256 with ``chunk=128``
  against two B = 128 calls, and the 8x8 grid with the distribute-pass
  division on against off;
* ``map_serving``: ``map_assignment_batch`` on ``hailfinder_like()`` with and
  without ``chunk=`` (the tree-MAP program), on the 5,000-chain (the Viterbi
  loop), and ``top_k_assignments_batch(k=5)`` on the 8x8 grid;
* ``entropy_joint_serving``: ``entropy_batch`` and ``joint_marginal_batch``
  on the big clique (every big contraction runs the kernel, at C = 1, 4 and
  8), held to float64, a far-apart joint and ``mutual_information`` on
  ``hailfinder_like()``, and ``entropy_batch`` on its log-sum-exp engine;
* ``incremental_serving``: an ``Engine.incremental`` session on
  ``hailfinder_like()`` and on the big clique with 18 two-variable tails (the
  session reaches the kernel through the same router), each delta held to a
  fresh ``posterior_batch`` under the merged evidence, the second also to
  the float64 engine;
* ``surgery_checkpoint``: ``multiply_factor`` against an engine built on
  ``surgery.add_factor``'s plan, ``save`` and ``load(device=...)``, and
  ``max_feasible_batch`` beside the measured peak;
* ``kernel_backward_vs_plain``: the three gradients of the kernel's
  ``torch.autograd.Function`` at the two serving shapes against
  ``torch.autograd.grad`` of the plain version, with the time of each piece
  beside its bound and both ways of taking ``dw2``;
* ``learning``: ``learn.expected_counts`` and three steps of
  ``fit_mle_missing`` on the big clique (N = 4096 rows, 6 of 18 columns
  missing) and on the big clique with 18 tails (whose backward pass launches
  the kernel for ``dw1`` and ``dw2``), held to float64 and to launch counts
  taken on meta tensors; ``fit_mle_chain`` on the 5,000-chain; and
  ``expected_counts`` on ``hailfinder_like()`` (the einsum route under
  autograd);
* ``solvers``: Marginal MAP on the 6x6 grid (B = 2048), ``CutsetEngine`` on
  ``hailfinder_like()`` (B = 1024) against the monolithic engine, loopy BP
  on the 30x30 grid (B = 256) against its CPU run, 100,000 exact samples of
  the sprinkler network, and ``chow_liu`` on samples of a tree;
* ``parallel``: the parallel surface on meshes that repeat cuda:0: the big
  clique under ``shard_model`` over 4 model shards, and over 2 x 2 with the
  rows split too (every routed contraction launches the kernel once per
  shard), held to the unsharded engine and to float64, with the sharded
  contraction's time beside one launch's; ``shard_batch`` of the 8x8 grid
  (``posterior_batch``, ``map_assignment_batch(chunk=)``); ``shard_sequence``
  of the 5,000-chain (the log-depth program) against the sequential program
  and float64; the forest engine against the monolithic one; two processes
  over ``torch.distributed`` (gloo), each serving half of the rows; loopy BP
  with its batch over a mesh.

With ``--profile`` the serving models, the learning steps and the solvers
also print their device time by kernel (``torch.profiler``).  Each phase prints one JSON line; the kernel
table and the card's name and power limit come before the last line, which
is ``{"ok": true, "device": {...}}``.  Any failure raises, and the script
exits non-zero without that line.  It needs a CUDA device and never falls
back to the CPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_bound_ms(R1, R2, C, B, bf16):
    """Least time the card could take for one contraction: the larger of
    its operations over the peak rate of their type and its bytes (each
    input read once, the output written once) over the memory rate
    (``ops.autotune.contraction_bound``, one H100 SXM's published peaks)."""
    from junctiontree_tpu_torch.ops.autotune import contraction_bound

    _, _, ms, by = contraction_bound(R1, R2, C, B, bf16)
    return ms, by


def split_line(pot, w1, w2):
    """The float32 pre-pass of one kernel call with these operands: its
    launches a call on a tensor handed in (0 for bf16 and for the narrow
    CUDA-core route; a standing potential's is kept after its first), its
    device time alone beside its plain version's and its bound (the bytes
    of pot read once and of the planes and exponents written once), and
    its planes held bitwise against the plain version
    (``reference_split_pot``)."""
    import torch

    from junctiontree_tpu_torch.ops import factored_contract as fc
    from junctiontree_tpu_torch.ops.cuda_build import load_library
    from junctiontree_tpu_torch.utils.bench_kernel import device_ms

    R1, R2, C = (int(d) for d in pot.shape)
    B = int(w1.shape[0])
    bf16 = torch.bfloat16 in {pot.dtype, w1.dtype, w2.dtype}
    cfg = fc.launch_config(B, R1, R2, C, torch.cuda.get_device_properties(
        pot.device).multi_processor_count, bf16)
    if cfg["src"] not in ("f32x6", "f32x1"):
        return {"split_launches_per_call": 0, "route": cfg["src"]}
    lib, stream = load_library(), torch.cuda.current_stream().cuda_stream
    counts = K1Counts()
    buf, ld, _ = fc._split_pot(lib, pot, cfg, stream)
    rows = R2 if cfg["by_n"] else R1 * R2
    n = cfg["planes"] * rows * ld
    planes, exps = fc.reference_split_pot(pot, cfg["by_n"], cfg["bk"],
                                          cfg["planes"])
    torch.cuda.synchronize()
    require(torch.equal(buf[:n].view(planes.shape), planes)
            and torch.equal(buf[n:].view(torch.int32), exps),
            f"the pot split disagrees with its plain version at {R1, R2, C}")
    ms = device_ms(lambda: fc._split_pot(lib, pot, cfg, stream))
    # not the caller's work
    take_back("factored_masked_contract.splits", counts.splits)
    plain = device_ms(lambda: fc.reference_split_pot(
        pot, cfg["by_n"], cfg["bk"], cfg["planes"]))
    elems, boxes, _ = fc._operand_elems(R1, R2, C, cfg)
    bound = (4 * R1 * R2 * C + 2 * elems + 4 * boxes) / HBM_BYTES_PER_S * 1e3
    return {"split_launches_per_call": 1, "split_ms": ms,
            "split_plain_ms": plain, "split_bound_ms": bound,
            "split_matches_plain": True, "route": cfg["src"]}


# one H100 SXM's memory rate (the data sheet's 3.35 TB/s)
HBM_BYTES_PER_S = 3.35e12


def in_kernel_sum(pot, w1, w2, got):
    """How many r2 partials a tile of one call with these operands leaves
    (``nparts``, with the card's own cluster slots), and where there are
    several, that 19 more runs and 5 on each of two streams at once give
    ``got``'s bits: the last block of each tile adds them in a fixed order,
    whichever block that is."""
    import functools

    import torch

    from junctiontree_tpu_torch.ops import factored_contract as fc

    R1, R2, C = (int(d) for d in pot.shape)
    B = int(w1.shape[0])
    bf16 = torch.bfloat16 in {pot.dtype, w1.dtype, w2.dtype}
    src = fc.source(bf16, "highest", R1 * C if fc.tiles_by_n(C) else None)
    cfg = fc.launch_config(B, R1, R2, C, fc._sm_count(pot.device), bf16,
                           functools.partial(fc._cluster_slots, pot.device,
                                             src))
    line = {"nparts": cfg["nparts"], "nsplit": cfg["nsplit"],
            "kparts": cfg["kparts"]}
    if cfg["nparts"] == 1:
        return line
    runs = [fc.factored_masked_contract(pot, w1, w2) for _ in range(19)]
    torch.cuda.synchronize()
    for st in (torch.cuda.Stream(), torch.cuda.Stream()):
        with torch.cuda.stream(st):
            runs += [fc.factored_masked_contract(pot, w1, w2)
                     for _ in range(5)]
    torch.cuda.synchronize()
    require(all(torch.equal(got, r) for r in runs),
            f"the in-kernel sum differs between runs at {R1, R2, C, B}")
    line["bitwise_repeatable_runs"] = 1 + len(runs)
    return line


def step_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median host milliseconds of one serving step ending in a sync."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_step(fn, steps: int = 5):
    """Device time by kernel over ``steps`` calls of ``fn`` (torch.profiler):
    (device-busy ms per step, kernel launches per step, the eight kernels
    with the most time as [name, launches per step, ms per step]).
    ``profile_step.copies`` is then the launches per step of PyTorch's copy
    kernels (names holding "copy")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    # the program's spans lie on the device lanes too (user annotations)
    rows = [(e.key, e.count / steps, e.device_time_total / steps / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[2])
    profile_step.copies = sum(n for k, n, _ in rows if "copy" in k.lower())
    return (sum(r[2] for r in rows), sum(r[1] for r in rows),
            [[k[:60], n, ms] for k, n, ms in rows[:8]])


def kept_counts(fn):
    """What one ``fn()`` did about the pot operands the kernel reads:
    float32 splits made, kept operands found (``kept.hits``) and made."""
    import torch

    from junctiontree_tpu_torch.utils.timing import TIMERS

    before = TIMERS.counters()
    fn()
    torch.cuda.synchronize()
    after = TIMERS.counters()
    return {key: after[name] - before[name] for key, name in (
        ("splits", "factored_masked_contract.splits"),
        ("kept_hits", "kept.hits"), ("kept_made", "kept.misses"))}


def big_clique_model():
    """One dense factor over 18 binary variables plus 18 unaries, seeded
    (the JAX package's big-clique benchmark configuration)."""
    import numpy as np

    rng = np.random.default_rng(0)
    names = [f"v{i}" for i in range(18)]
    factors = [names[:]] + [[n] for n in names]
    sizes = {n: 2 for n in names}
    values = [rng.random((2,) * 18).astype(np.float32) + 0.1] + [
        rng.random(2) + 0.1 for _ in names
    ]
    return factors, sizes, values, names


def k1_calls_on_meta(plan, values, run):
    """What ``run(engine)`` asks of the kernel, from a run on meta tensors
    (shapes only, nothing computed, no device): the (R1, R2, C, B) of every
    call the route makes to the kernel's wrapper, in order."""
    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.ops import factored_contract as fc

    shapes = []
    wrapped = fc.factored_masked_contract

    def record(pot, w1, w2):
        shapes.append(tuple(int(d) for d in pot.shape) + (int(w1.shape[0]),))
        return wrapped(pot, w1, w2)

    eng = jt.Engine(plan, device="meta").set_potentials(values)
    calls = route_calls()
    fc.factored_masked_contract = record
    try:
        run(eng)
    finally:
        fc.factored_masked_contract = wrapped
    require(route_calls() - calls == len(shapes),
            "route calls and kernel calls differ on meta tensors")
    return shapes


# float32 serving against the same engine in float64
F64_LIMITS = dict(rtol=1e-4, atol=1e-6, logz_atol=1e-4)


def peak_bytes(fn):
    """(result of ``fn()``, peak bytes allocated on the card during it)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


class K1Counts:
    """The big-clique kernel wrapper's counters since this object was made,
    by the names after ``factored_masked_contract.`` in
    ``TIMERS.counters()``: ``launches``, ``launches_bf16``,
    ``launches_backward``, ``splits``, ``padded``."""

    def __init__(self):
        self._base = counters()

    def __getattr__(self, name):
        key = "factored_masked_contract." + name
        return counters()[key] - self._base[key]


def counters():
    """Every counter of the port by name, now."""
    from junctiontree_tpu_torch.utils.timing import TIMERS

    return TIMERS.counters()


def route_calls():
    """The big-clique route's contractions so far."""
    return counters()["big_clique_sep_message.calls"]


def take_back(name, n):
    """Take ``n`` back out of the counter ``name``: work that is not the
    caller's."""
    from junctiontree_tpu_torch.utils.timing import TIMERS

    TIMERS.add(name, -n)


def check_close(post, logz, ref_post, ref_logz, n_vars, what, *, rtol, atol,
                logz_atol, rows=None):
    """Posteriors (indexable by var id) and logZ against a reference on the
    first ``rows`` rows: -inf rows agree, rows of impossible evidence are
    zero, nothing is NaN.  Returns the largest absolute posterior error."""
    import numpy as np

    rows = int(logz.shape[0]) if rows is None else rows
    lz = logz[:rows].double().cpu().numpy()
    rlz = ref_logz[:rows].double().cpu().numpy()
    require(np.array_equal(np.isneginf(lz), np.isneginf(rlz)),
            f"{what}: -inf rows differ from the reference")
    fin = np.isfinite(rlz)
    np.testing.assert_allclose(lz[fin], rlz[fin], rtol=0, atol=logz_atol,
                               err_msg=f"{what}: logZ")
    worst = 0.0
    for v in range(n_vars):
        p = post[v][:rows].double().cpu().numpy()
        rp = ref_post[v][:rows].double().cpu().numpy()
        require(np.isfinite(p).all(), f"{what}: non-finite posterior")
        require((p[~fin] == 0).all(), f"{what}: impossible row is not zero")
        np.testing.assert_allclose(p, rp, rtol=rtol, atol=atol,
                                   err_msg=f"{what}: posteriors")
        worst = max(worst, float(np.abs(p - rp).max()))
    return worst


def phase_bf16(dev, tree, values, masks, f32_post, f32_logz,
               f32_step_ms, f32_peak, expect_launches, profile):
    """The big-clique model with bfloat16 storage: the kernel's bf16 variant
    on the main path, held to the float32 engine on the same masks (the JAX
    package's own limits: posteriors 0.02, logZ 0.05)."""
    import torch

    eng = tree.engine(device=dev, dtype=torch.bfloat16).set_potentials(values)
    k1 = K1Counts()
    (post, logz), peak = peak_bytes(lambda: eng.posterior_batch(masks))
    launches = k1.launches
    launches_bf16 = k1.launches_bf16
    require(launches == launches_bf16 == expect_launches,
            f"bf16 serving: {launches} kernel launches, {launches_bf16} with "
            f"bf16 inputs, expected {expect_launches}")
    require(logz.dtype == torch.float32
            and all(p.dtype == torch.float32 for p in post),
            "bf16 serving: outputs are not float32")
    require(all(p.dtype == torch.bfloat16 for p in eng._program_pots()),
            "bf16 serving: potentials are not stored in bfloat16")
    require(k1.splits == 0, "bf16 serving split a potential")
    steady = kept_counts(lambda: eng.posterior_batch(masks))
    require(steady["kept_hits"] == launches and steady["kept_made"] == 0,
            f"a steady bf16 posterior_batch: {steady}")
    worst = check_close(post, logz, f32_post, f32_logz, len(post),
                        "bf16 serving", rtol=0, atol=0.02, logz_atol=0.05)
    require(bool(torch.isneginf(logz[0])) and all(
        bool((p[0] == 0).all()) for p in post),
        "bf16 serving: impossible row is not zero / -inf")
    fin = torch.isfinite(f32_logz)
    t = step_ms(lambda: eng.posterior_batch(masks))
    B = int(logz.shape[0])
    if profile:
        busy, n_kernels, top = profile_step(lambda: eng.posterior_batch(masks))
        emit({"phase": "profile", "model": "big_clique_bf16", "step_ms": t,
              "device_busy_ms_per_step": busy,
              "kernels_per_step": n_kernels,
              "copy_kernels_per_step": profile_step.copies,
              "top_kernels": top})
    emit({"phase": "bf16_serving", "B": B, "kernel_launches": launches,
          "steady_call": steady,
          "kept_layouts": eng.describe()["kept_layouts"],
          "kernel_launches_bf16_inputs": launches_bf16, "step_ms": t,
          "f32_step_ms": f32_step_ms, "queries_per_s": B / t * 1e3,
          "peak_mem_bytes": peak, "f32_peak_mem_bytes": f32_peak,
          "max_abs_err_vs_f32": worst,
          "max_logz_err_vs_f32": (logz - f32_logz)[fin].abs().max().item(),
          "limits": {"posterior_atol": 0.02, "logz_atol": 0.05}})
    return launches


def phase_log(dev, tree, values, masks, lin_post, lin_logz):
    """hailfinder_like on the LOG_SUM_EXP engine (the log-matmul-exp branch
    at 12.4M-state scopes) against the sum-product engine's result on the
    same evidence, and one MAX_PRODUCT posterior on sprinkler."""
    import numpy as np
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.models import sprinkler_model
    from junctiontree_tpu_torch.ops import semirings

    eng = tree.engine("log_sum_exp", device=dev).set_potentials(values)
    shifted = {"calls": 0, "largest_scope_states": 0}
    inner = semirings._log_matmul_exp

    def counting(operands, operand_vars, out_vars):
        ext = semirings._extents(operands, operand_vars)
        shifted["calls"] += 1
        shifted["largest_scope_states"] = max(
            shifted["largest_scope_states"],
            semirings._states([v for v in ext if v != -1], ext))
        return inner(operands, operand_vars, out_vars)

    # the largest power of two up to the sum-product phase's batch that fits
    B = int(lin_logz.shape[0])
    semirings._log_matmul_exp = counting
    try:
        while True:
            log_masks = {k: np.where(m[:B] > 0, 0.0, -np.inf).astype(np.float32)
                         for k, m in masks.items()}
            k1 = K1Counts()
            try:
                (post, logz), peak = peak_bytes(
                    lambda: eng.posterior_batch(log_masks))
                break
            except torch.cuda.OutOfMemoryError:
                require(B > 1, "log serving: B = 1 does not fit")
                torch.cuda.empty_cache()
                B //= 2
    finally:
        semirings._log_matmul_exp = inner
    launches = k1.launches
    require(launches == 0, f"log serving launched the kernel {launches} times")
    require(shifted["calls"] > 0, "log serving never took log-matmul-exp")
    worst = check_close(post, logz, lin_post, lin_logz, len(post),
                        "log serving", rtol=1e-4, atol=1e-6, logz_atol=1e-3,
                        rows=B)
    require(bool(torch.isneginf(logz[1])), "log serving: impossible row")
    t = step_ms(lambda: eng.posterior_batch(log_masks), iters=2, warmup=0)
    del eng, post
    # one max-product posterior on the card against query
    f, s, v = sprinkler_model()
    st = jt.create_junction_tree(f, s)
    meng = st.engine("max_product", device=dev).set_potentials(v)
    mp, _ = meng.posterior_batch(
        jt.batch_masks_sparse(st.plan, [{"wet_grass": 1}], jt.MAX_PRODUCT))
    mq, _ = meng.query({"wet_grass": 1})
    for p, m in zip(mp, mq):
        np.testing.assert_allclose(p[0].cpu().numpy(), m / m.max(), rtol=1e-5,
                                   err_msg="max-product sprinkler posterior")
    fin = torch.isfinite(lin_logz[:B])
    emit({"phase": "log_serving", "model": "hailfinder_like", "B": B,
          "semiring": "log_sum_exp", "kernel_launches": launches,
          "log_matmul_exp_calls": shifted["calls"],
          "largest_shifted_scope_states": shifted["largest_scope_states"],
          "step_ms": t, "queries_per_s": B / t * 1e3, "peak_mem_bytes": peak,
          "max_abs_err_vs_sum_product": worst,
          "max_logz_err_vs_sum_product":
              (logz - lin_logz[:B])[fin].abs().max().item(),
          "limits": {"rtol": 1e-4, "atol": 1e-6, "logz_atol": 1e-3},
          "max_product_sprinkler_matches_query": True})


def phase_chain(dev, profile):
    """A 5,000-variable chain, B = 1024, auto mode: the forward-backward
    program, 16 rows against the same program in float64, and a 200-variable
    chain against the general program.  Returns the 5,000-chain's (tree,
    values, masks) for the MAP phase."""
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.models import chain_bn_model
    from junctiontree_tpu_torch.scan_executor import StackedPosteriors

    n, B = 5000, 1024
    factors, sizes, values = chain_bn_model(n, seed=1)
    t0 = time.perf_counter()
    tree = jt.create_junction_tree(factors, sizes)
    build = time.perf_counter() - t0
    labels = [f"x{i}" for i in range(0, n, 500)]
    masks = jt.batch_masks_sparse(
        tree.plan, jt.random_evidence_batch(tree.plan, B, labels, seed=2))
    masks[labels[3]][2] = 0.0  # row 2: impossible evidence
    eng = tree.engine(device=dev).set_potentials(values)
    k1 = K1Counts()
    (post, logz), peak = peak_bytes(lambda: eng.posterior_batch(masks))
    launches = k1.launches
    require(isinstance(post, StackedPosteriors) and eng._route("auto") == "chain",
            "chain serving: auto mode did not take the chain program")
    require(launches == 0, "chain serving launched the big-clique kernel")
    require(tuple(post.stacked.shape) == (n, B, 2), "chain posterior shape")
    rows = 16
    ref = tree.engine(device=dev, dtype=torch.float64).set_potentials(values)
    ref_post, ref_logz = ref.posterior_batch(
        {k: v[:rows] for k, v in masks.items()})
    require(bool(torch.isneginf(logz[2])), "chain: impossible row logZ")
    lz_err = (logz[:rows].double() - ref_logz)[
        torch.isfinite(ref_logz)].abs().max().item()
    require(lz_err <= 1e-2, f"chain: logZ differs from float64 by {lz_err}")
    err = (post.stacked[:, :rows].double() - ref_post.stacked).abs().max().item()
    require(err <= 1e-4 and not bool(torch.isnan(post.stacked).any()),
            f"chain: posteriors differ from float64 by {err}")
    require(bool((post.stacked[:, 2] == 0).all()), "chain: impossible row")
    t = step_ms(lambda: eng.posterior_batch(masks), iters=3, warmup=1)
    line = {"phase": "chain_serving", "variables": n, "B": B,
            "program": "chain", "plan_build_s": build, "step_ms": t,
            "queries_per_s": B / t * 1e3, "us_per_chain_step": t * 1e3 / (2 * (n - 1)),
            "peak_mem_bytes": peak, "kernel_launches": launches,
            "max_abs_err_vs_f64": err, "max_logz_err_vs_f64": lz_err,
            "rows_checked": rows,
            "limits": {"posterior_atol": 1e-4, "logz_atol": 1e-2}}
    if profile:
        busy, n_kernels, top = profile_step(
            lambda: eng.posterior_batch(masks), steps=2)
        line.update(device_busy_ms_per_step=busy, kernels_per_step=n_kernels,
                    top_kernels=top[:4])
    del eng, ref, post, ref_post
    long_chain = (tree, values, masks)
    # a 200-variable chain: the chain program against the general one
    factors, sizes, values = chain_bn_model(200, card=3, seed=3)
    tree = jt.create_junction_tree(factors, sizes)
    masks = jt.batch_masks_sparse(
        tree.plan, jt.random_evidence_batch(
            tree.plan, 64, ["x0", "x77", "x199"], seed=4))
    masks["x77"][5] = 0.0
    eng = tree.engine(device=dev).set_potentials(values)
    cpost, clogz = eng.posterior_batch(masks)
    gpost, glogz = eng.posterior_batch(masks, mode="general")
    require(isinstance(cpost, StackedPosteriors) and isinstance(gpost, list),
            "chain 200: programs")
    line["chain200_max_abs_err_vs_general"] = check_close(
        cpost, clogz, gpost, glogz, 200, "chain 200 vs general",
        rtol=1e-4, atol=1e-6, logz_atol=1e-3)
    emit(line)
    return long_chain


def phase_chain_step_kernel(dev):
    """The chain program's step (the library's product, then the row kernel
    of ``csrc/chain_step.cu``) at the HMM cell's shape, [16384, 500] x [500,
    500] float32: its device ms forward and backward against the plain
    step (the product and ``chain_step.reference_rows``), the library's
    product alone, the row kernel alone and the FP32 bound
    (``bench_kernel.chain_lines``), with its errors against the plain step
    in float32 and float64; then one HMM ``posterior_batch`` at the cell's
    shape (K = 500, 256 sites, B = 16,384, one site in ten typed, row 0
    impossible) with its row-kernel launches (``chain_step.launches``)
    counted around that call alone, its first 2,048 rows against the same
    call on the plain steps.
    Returns the ``kernels`` entry."""
    import numpy as np
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.models.hmm import li_stephens_model, typed_sites
    from junctiontree_tpu_torch.ops import chain_step
    from junctiontree_tpu_torch.utils.bench_kernel import chain_lines
    from junctiontree_tpu_torch.utils.timing import TIMERS

    (line,) = chain_lines(dev)
    errs = {k: v for k, v in line.items() if "_vs_plain_" in k}
    # rounding bound of a float32 sum of K = 500 non-negative products,
    # relative to the largest value (tests/test_torch_chain_step.py)
    require(all(v <= 2 * 4 * 500 * 2.0**-24 for v in errs.values()),
            f"chain step against its plain version: {errs}")
    torch.cuda.empty_cache()
    K, M, B, rows = 500, 256, 16384, 2048
    factors, sizes, values = li_stephens_model(K, M, seed=0)
    eng = jt.create_junction_tree(factors, sizes).engine(
        device=dev).set_potentials(values)
    rng = np.random.default_rng(3)
    masks = {}
    for y in typed_sites(M, 10):
        mk = np.zeros((B, 2), dtype=np.float32)
        mk[np.arange(B), rng.integers(2, size=B)] = 1.0
        masks[y] = mk
    masks["y0"][0] = 0.0
    eng.posterior_batch(masks)  # warm: the pool and the plan
    torch.cuda.synchronize()
    before = TIMERS.counters()
    post, logz = eng.posterior_batch(masks)
    torch.cuda.synchronize()
    after = TIMERS.counters()
    launches = after["chain_step.launches"] - before["chain_step.launches"]
    require(launches == 2 * (M - 1),
            f"HMM posterior_batch: {launches} row-kernel launches, "
            f"expected {2 * (M - 1)}")
    engages = chain_step.engages
    chain_step.engages = lambda *a: False
    try:
        ppost, plogz = eng.posterior_batch(
            {y: mk[:rows] for y, mk in masks.items()})
    finally:
        chain_step.engages = engages
    require(bool(torch.isneginf(logz[0])) and not bool(post[0][0].any()),
            "HMM through the kernel: impossible row")
    ok = torch.isfinite(plogz)
    lz_err = (logz[:rows][ok] - plogz[ok]).abs().max().item()
    err = max((post[v][:rows] - ppost[v]).abs().max().item()
              for v in range(len(post)))
    require(err <= 1e-4 and lz_err <= 1e-3,
            f"HMM through the kernel against the plain steps: posteriors "
            f"{err}, logZ {lz_err}")
    line.update(phase="chain_step_kernel", hmm_sites=M, hmm_B=B,
                hmm_kernel_launches=launches,
                hmm_rows_vs_plain=rows, hmm_max_abs_err_vs_plain=err,
                hmm_logz_err_vs_plain=lz_err)
    emit(line)
    del eng, post, ppost
    torch.cuda.empty_cache()
    return {
        "name": "chain_rows_kernel (float32, the chain step's row pass)",
        "route": "cuda",
        "source": "junctiontree_tpu_torch/csrc/chain_step.cu",
        "replaces": None,
        "launches": launches, "max_abs_err": max(errs.values()),
        "ms": line["step_ms_forward"], "ms_backward":
            line["step_ms_backward"],
        "plain_ms": line["plain_ms_forward"],
        "plain_ms_backward": line["plain_ms_backward"],
        "bound_ms": line["bound_ms"], "bound_by": "operations",
        "library_ms": line["library_product_ms"],
        "per": "ms: one chain step, [16384, 500] x [500, 500] float32, the "
               "library's product and the row kernel (forward; backward "
               "with the position's posterior beside it); launches of the "
               "row kernel: one HMM posterior_batch at K = 500, 256 "
               "sites, B = 16,384 (2(M - 1) = %d steps)" % (2 * (M - 1)),
    }


def phase_fused(dev, profile):
    """A 1,000-leaf star, B = 1024: auto mode must take the level-fused
    program; and the 8x8 grid, B = 4096, fused against general.  Returns
    the grid's (tree, values, masks, general result, general step ms) for
    the division check."""
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.fused import FusedPosteriors
    from junctiontree_tpu_torch.models import grid_mrf_model, star_bn_model

    n, B = 1000, 1024
    factors, sizes, values = star_bn_model(n, card=3)
    t0 = time.perf_counter()
    tree = jt.create_junction_tree(factors, sizes)
    build = time.perf_counter() - t0
    labels = [f"leaf{i}" for i in range(0, n, 10)]
    masks = jt.batch_masks_sparse(
        tree.plan, jt.random_evidence_batch(tree.plan, B, labels, seed=5))
    masks[labels[1]][4] = 0.0  # row 4: impossible evidence
    eng = tree.engine(device=dev).set_potentials(values)
    k1 = K1Counts()
    (post, logz), peak = peak_bytes(lambda: eng.posterior_batch(masks))
    launches = k1.launches
    require(isinstance(post, FusedPosteriors) and eng._route("auto") == "fused",
            "fused serving: auto mode did not take the fused program")
    require(launches == 0, "fused serving launched the big-clique kernel")
    sched = eng._fused_schedule()[0]
    rows = 16
    ref = tree.engine(device=dev, dtype=torch.float64).set_potentials(values)
    ref_post, ref_logz = ref.posterior_batch(
        {k: v[:rows] for k, v in masks.items()}, mode="fused")
    star_err = check_close(post, logz, ref_post, ref_logz, n + 1,
                           "star vs float64", rtol=1e-4, atol=1e-6,
                           logz_atol=1e-2, rows=rows)
    require(bool(torch.isneginf(logz[4])), "star: impossible row logZ")
    t_star = step_ms(lambda: eng.posterior_batch(masks), iters=3, warmup=1)
    line = {"phase": "fused_serving", "star_leaves": n, "star_B": B,
            "star_program": "fused", "star_plan_build_s": build,
            "star_groups": sum(len(gs) for gs in sched.levels),
            "star_cliques": tree.plan.tri.num_cliques,
            "star_step_ms": t_star, "star_queries_per_s": B / t_star * 1e3,
            "star_peak_mem_bytes": peak, "star_kernel_launches": launches,
            "star_max_abs_err_vs_f64": star_err, "star_rows_checked": rows}
    if profile:
        busy, n_kernels, top = profile_step(
            lambda: eng.posterior_batch(masks), steps=2)
        line.update(star_device_busy_ms_per_step=busy,
                    star_kernels_per_step=n_kernels)
    del eng, ref, post, ref_post
    # the 8x8 grid, fused against general
    Bg = 4096
    factors, sizes, values = grid_mrf_model(8, 8, seed=0)
    tree = jt.create_junction_tree(factors, sizes)
    masks = jt.batch_masks_sparse(
        tree.plan, jt.random_evidence_batch(tree.plan, Bg, list(sizes)[:20], seed=1))
    masks[list(sizes)[0]][7] = 0.0
    eng = tree.engine(device=dev).set_potentials(values)
    require(eng._route("auto") == "general", "8x8 grid: auto mode")
    fpost, flogz = eng.posterior_batch(masks, mode="fused")
    gpost, glogz = eng.posterior_batch(masks, mode="general")
    require(isinstance(fpost, FusedPosteriors), "8x8 grid: fused program")
    grid_err = check_close(fpost, flogz, gpost, glogz, 64, "8x8 fused vs general",
                           rtol=1e-5, atol=1e-6, logz_atol=1e-3, rows=64)
    t_f = step_ms(lambda: eng.posterior_batch(masks, mode="fused"), iters=5)
    t_g = step_ms(lambda: eng.posterior_batch(masks, mode="general"), iters=5)
    gsched = eng._fused_schedule()[0]
    line.update(grid="8x8", grid_B=Bg, grid_cliques=tree.plan.tri.num_cliques,
                grid_groups=sum(len(gs) for gs in gsched.levels),
                grid_fused_step_ms=t_f, grid_general_step_ms=t_g,
                grid_max_abs_err_fused_vs_general=grid_err,
                grid_rows_checked=64,
                limits={"rtol": 1e-5, "atol": 1e-6})
    emit(line)
    return tree, values, masks, gpost, glogz, t_g


def phase_chunked(dev, hail_eng, hail_plan, grid):
    """hailfinder_like B = 256 with chunk=128 against two unchunked B = 128
    calls (results and peak memory), and the 8x8 grid with the
    distribute-pass division on against off."""
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.config import DEFAULT

    B, chunk = 256, 128
    labels = [hail_plan.table.label_of(v) for v in range(hail_plan.num_vars)][::3]
    masks = jt.batch_masks_sparse(
        hail_plan, jt.random_evidence_batch(hail_plan, B, labels, seed=6))
    masks[labels[0]][200] = 0.0  # an impossible row in the second chunk
    halves = [{k: v[lo:lo + chunk] for k, v in masks.items()}
              for lo in (0, chunk)]
    (first, peak_half) = peak_bytes(lambda: hail_eng.posterior_batch(halves[0]))
    second = hail_eng.posterior_batch(halves[1])
    t0 = time.perf_counter()
    (cpost, clogz), peak_chunked = peak_bytes(
        lambda: hail_eng.posterior_batch(masks, chunk=chunk))
    t_chunked = (time.perf_counter() - t0) * 1e3
    want_logz = torch.cat([first[1], second[1]])
    require(torch.equal(torch.isneginf(clogz), torch.isneginf(want_logz))
            and bool(torch.isneginf(clogz[200])), "chunked: -inf rows")
    worst = 0.0
    for v in range(hail_plan.num_vars):
        want = torch.cat([first[0][v], second[0][v]])
        require(tuple(cpost[v].shape) == tuple(want.shape), "chunked: shapes")
        worst = max(worst, (cpost[v] - want).abs().max().item())
    fin = torch.isfinite(want_logz)
    lz = (clogz - want_logz)[fin].abs().max().item()
    require(worst <= 1e-6 and lz <= 1e-5,
            f"chunked differs from unchunked: {worst}, logZ {lz}")
    line = {"phase": "chunked_serving", "model": "hailfinder_like", "B": B,
            "chunk": chunk, "step_ms": t_chunked,
            "queries_per_s": B / t_chunked * 1e3,
            "peak_mem_bytes": peak_chunked,
            "unchunked_half_peak_mem_bytes": peak_half,
            "max_abs_err_vs_two_unchunked_calls": worst,
            "max_logz_err_vs_two_unchunked_calls": lz,
            "limits": {"posterior_atol": 1e-6, "logz_atol": 1e-5}}
    # the distribute-pass division on the 8x8 grid against the default
    tree, values, gmasks, gpost, glogz, t_default = grid
    require(not DEFAULT.distribute_division, "division is on by default")
    DEFAULT.distribute_division = True
    try:
        eng = jt.Engine(tree.plan, device=dev).set_potentials(values)
        dpost, dlogz = eng.posterior_batch(gmasks, mode="general")
        t_div = step_ms(lambda: eng.posterior_batch(gmasks, mode="general"),
                        iters=5)
    finally:
        DEFAULT.distribute_division = False
    line.update(
        division_grid="8x8", division_B=int(glogz.shape[0]),
        division_step_ms=t_div, default_step_ms=t_default,
        division_max_abs_err_vs_default=check_close(
            dpost, dlogz, gpost, glogz, 64, "division vs default",
            rtol=1e-5, atol=1e-6, logz_atol=1e-3))
    emit(line)


def log_masks(masks, rows=None):
    """Linear 0/1 evidence masks as log-space masks (0 / -inf)."""
    import numpy as np

    return {k: np.where(m[:rows] > 0, 0.0, -np.inf).astype(np.float32)
            for k, m in masks.items()}


def tree_map_bytes(plan, B, itemsize=4):
    """Reckoned peak of the tree-MAP program at batch B: the largest
    clique's [B, states] scores and their (sep, rest)-ordered copy, every
    clique's int32 [B, sep_states] backpointers, and the largest separator's
    maxima with their int64 indices."""
    st = plan.stats()
    sep_total = 0
    for sv in plan.sep_vars:
        n = 1
        for v in sv:
            n *= plan.sizes[v]
        sep_total += n
    return B * (2 * st["max_clique_states"] * itemsize + 4 * sep_total
                + st["max_sep_states"] * (itemsize + 8 + 4))


def same_collects(eng, masks, what):
    """Every clique's fused collect against the plain one on the same
    inputs (``bench_kernel.collect_pairs``): scores bit for bit, the same
    indices.  Returns the pairs."""
    import torch

    from junctiontree_tpu_torch.utils.bench_kernel import collect_pairs

    pairs = collect_pairs(eng, masks)
    for c, fused, plain, _ in pairs:
        (fv, fi), (pv, pi) = fused(), plain()
        require(fv.shape == pv.shape and torch.equal(
            fv.view(torch.int32), pv.view(torch.int32)),
            f"{what}, clique {c}: the fused collect's scores differ from the "
            "plain collect's")
        require(torch.equal(fi.long(), pi.long()),
                f"{what}, clique {c}: the fused collect's indices differ "
                "from the plain collect's")
    return pairs


def phase_map_kernel(dev, big):
    """The fused collect (``csrc/map_collect.cu``) at the MAP cell's shape:
    the 2^18-state root at B = 4,096 with 12 masks (row 0 impossible),
    bit for bit against the plain collect on the same inputs, its launches
    in one ``map_assignment_batch`` call, device times and bound.  Returns
    the ``kernels`` entry."""
    import torch

    from junctiontree_tpu_torch.utils.bench_kernel import device_ms
    from junctiontree_tpu_torch.utils.timing import TIMERS

    eng = big["tree"].engine("max_product", device=dev).set_potentials(
        big["values"])
    masks = log_masks(big["masks"])
    ((_, fused, plain, bound),) = same_collects(eng, masks, "big clique")
    before = TIMERS.counters()["map.fused_cliques"]
    eng.map_assignment_batch(masks)
    launches = TIMERS.counters()["map.fused_cliques"] - before
    require(launches == 1, f"{launches} fused collects in one big-clique "
                           "map_assignment_batch, expected 1")
    ms, plain_ms = device_ms(fused), device_ms(plain, iters=5)
    B = int(next(iter(masks.values())).shape[0])
    emit({"phase": "map_kernel_vs_plain", "B": B, "states": 2**18,
          "masks": len(masks), "scores_bitwise_equal": True,
          "indices_equal": True, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound, "share_of_bound": bound / ms})
    del eng
    torch.cuda.empty_cache()
    return {
        "name": "map_collect_kernel (float32, tree-MAP collect)",
        "route": "cuda",
        "source": "junctiontree_tpu_torch/csrc/map_collect.cu",
        "replaces": None,
        "launches": launches, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "operations", "library_ms": None,
        "per": "one map_assignment_batch call on the big clique, B = 4,096, "
               "12 masks (%d launch, with a memset and the unpacking of its "
               "keys)" % launches,
    }


def phase_map(dev, hail, chain, grid, profile):
    """MAP and k-best decoding: the tree-MAP program on hailfinder_like with
    and without ``chunk=`` (every float32 clique collected by the fused
    kernel, each bit for bit against the plain collect on the same inputs),
    the Viterbi loop on the 5,000-chain, and
    ``top_k_assignments_batch(k=5)`` on the 8x8 grid."""
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.map_executor import tree_map_program
    from junctiontree_tpu_torch.models import chain_bn_model
    from junctiontree_tpu_torch.utils.timing import TIMERS

    # (a) hailfinder_like: the largest power-of-two B up to the posterior
    # phase's 128 whose reckoned peak stays under half the card's memory
    tree, plan = hail["tree"], hail["tree"].plan
    total = torch.cuda.get_device_properties(dev).total_memory
    B = hail["B"]
    while B > 1 and tree_map_bytes(plan, B) > total // 2:
        B //= 2
    masks = log_masks(hail["masks"], B)
    eng = tree.engine("max_product", device=dev).set_potentials(hail["values"])
    k1 = K1Counts()
    fused = TIMERS.counters()["map.fused_cliques"]
    (assign, score), peak = peak_bytes(lambda: eng.map_assignment_batch(masks))
    fused = TIMERS.counters()["map.fused_cliques"] - fused
    chunk = max(1, B // 4)
    (c_assign, c_score), c_peak = peak_bytes(
        lambda: eng.map_assignment_batch(masks, chunk=chunk))
    require(k1.launches == 0, "tree MAP launched the big-clique kernel")
    require(fused == len(plan.clique_vars),
            f"tree MAP collected {fused} of {len(plan.clique_vars)} float32 "
            "cliques with the fused kernel")
    require(assign.dtype == torch.int32
            and tuple(assign.shape) == (B, plan.num_vars), "MAP assignment")
    require(torch.equal(c_score, score) and torch.equal(c_assign, assign),
            "chunked MAP differs from the unchunked call")
    require(float(score[1]) < -1e29 and not bool(torch.isnan(score).any()),
            "MAP: the impossible row does not score below -1e29")
    # each assignment attains its score, and beats the per-variable argmax
    # of the posteriors (which need not be a consistent assignment)
    a_host, s_host = assign.cpu().numpy(), score.cpu().numpy()
    greedy = torch.stack(
        [hail["post"][v][:B].argmax(dim=-1) for v in range(plan.num_vars)], dim=1
    ).cpu().numpy()
    checked, worst, beaten = [0] + list(range(2, 10)), 0.0, 0
    for b in checked:
        own = eng.score_assignment(eng._labelled(a_host[b]))
        worst = max(worst, float(abs(own - s_host[b]) / abs(own)))
        other = eng.score_assignment(eng._labelled(greedy[b]))
        require(s_host[b] >= other - 1e-4 * abs(s_host[b]),
                f"MAP row {b}: score {s_host[b]} below the argmax assignment's {other}")
        beaten += bool(s_host[b] > other + 1e-4 * abs(s_host[b]))
    require(worst <= 1e-5, f"MAP: score_assignment differs from the score ({worst})")
    same_collects(eng, masks, "hailfinder_like")
    t = step_ms(lambda: eng.map_assignment_batch(masks), iters=3, warmup=1)
    t_c = step_ms(lambda: eng.map_assignment_batch(masks, chunk=chunk),
                  iters=3, warmup=1)
    line = {"phase": "map_serving", "model": "hailfinder_like", "B": B,
            "program": "tree_map", "step_ms": t, "queries_per_s": B / t * 1e3,
            "peak_mem_bytes": peak, "reckoned_peak_bytes": tree_map_bytes(plan, B),
            "chunk": chunk, "chunked_step_ms": t_c, "chunked_peak_mem_bytes": c_peak,
            "chunked_equal": True, "rows_scored": len(checked),
            "max_rel_err_score_assignment": worst,
            "rows_strictly_above_posterior_argmax": int(beaten),
            "kernel_launches": k1.launches,
            "fused_cliques": fused, "cliques": len(plan.clique_vars),
            "collects_bitwise_equal_plain": len(plan.clique_vars)}
    if profile:
        busy, n_kernels, top = profile_step(
            lambda: eng.map_assignment_batch(masks), steps=2)
        line.update(device_busy_ms_per_step=busy, kernels_per_step=n_kernels,
                    top_kernels=top[:4])
    del eng, assign, c_assign
    torch.cuda.empty_cache()

    # (b) the 5,000-chain, B = 1024: the Viterbi loop, not the tree program
    ctree, cvalues, cmasks = chain
    n, Bc = ctree.plan.num_vars, 1024
    ceng = ctree.engine("max_product", device=dev).set_potentials(cvalues)
    lm = log_masks(cmasks)
    (c_a, c_s), c_pk = peak_bytes(lambda: ceng.map_assignment_batch(lm))
    require(("viterbi",) in ceng._programs
            and not any(k[0] == "tree_map" for k in ceng._programs),
            "chain MAP did not take the Viterbi loop")
    require(tuple(c_a.shape) == (Bc, n) and c_a.dtype == torch.int32,
            "chain MAP assignment")
    require(bool(torch.isneginf(c_s[2])) and bool(torch.isfinite(c_s[3:]).all()),
            "chain MAP scores")
    own = ceng.score_assignment(ceng._labelled(c_a[0].cpu().numpy()))
    require(abs(own - float(c_s[0])) <= 1e-4 * abs(own),
            f"chain MAP: row 0 scores {float(c_s[0])}, its assignment {own}")
    t_v = step_ms(lambda: ceng.map_assignment_batch(lm), iters=3, warmup=1)
    line.update(chain_variables=n, chain_B=Bc, chain_program="viterbi",
                chain_step_ms=t_v, chain_queries_per_s=Bc / t_v * 1e3,
                chain_us_per_chain_step=t_v * 1e3 / (2 * (n - 1)),
                chain_peak_mem_bytes=c_pk,
                chain_launches_reckoned=4 * (n - 1))
    if profile:
        busy, n_kernels, _ = profile_step(
            lambda: ceng.map_assignment_batch(lm), steps=2)
        line.update(chain_device_busy_ms_per_step=busy,
                    chain_kernels_per_step=n_kernels)
    del ceng, c_a
    # a 200-variable chain: the Viterbi loop against the tree program
    f2, s2, v2 = chain_bn_model(200, card=3, seed=3)
    t2 = jt.create_junction_tree(f2, s2)
    e2 = t2.engine("max_product", device=dev).set_potentials(v2)
    m2 = log_masks(jt.batch_masks_sparse(t2.plan, jt.random_evidence_batch(
        t2.plan, 64, ["x0", "x77", "x199"], seed=4)))
    va, vs = e2.map_assignment_batch(m2)
    ids = tuple(sorted(t2.plan.table.id_of(k) for k in m2))
    ta, ts = tree_map_program(t2.plan, ids)(
        e2._pots, [e2._place(m2[t2.plan.table.label_of(v)]) for v in ids])
    err = ((vs - ts).abs() / ts.abs()).max().item()
    require(err <= 1e-5, f"Viterbi and tree-MAP scores differ on chain 200: {err}")
    line["chain200_max_rel_err_viterbi_vs_tree_map"] = err
    line["chain200_assignments_equal"] = bool(torch.equal(va, ta))

    # (c) the 8x8 grid, top_k_assignments_batch(k = 5), B = 1024
    gtree, gvalues, gmasks = grid[:3]
    Bg, k = 1024, 5
    gm = log_masks(gmasks, Bg)
    geng = gtree.engine("max_product", device=dev).set_potentials(gvalues)
    (ka, ks), k_pk = peak_bytes(lambda: geng.top_k_assignments_batch(gm, k=k))
    ma, ms = geng.map_assignment_batch(gm)
    ok = ms > -1e29
    require(int((~ok).sum()) == 1 and not bool(ok[7]), "k-best: impossible row")
    require(tuple(ka.shape) == (Bg, k, 64) and ka.dtype == torch.int32, "k-best shapes")
    require(bool((ks[:, :-1] >= ks[:, 1:]).all()), "k-best scores not descending")
    for i in range(k):
        for j in range(i + 1, k):
            require(bool((ka[ok, i] != ka[ok, j]).any(dim=-1).all()),
                    f"k-best: ranks {i} and {j} are one assignment in some row")
    first = ((ks[ok, 0] - ms[ok]).abs() / ms[ok].abs()).max().item()
    require(first <= 1e-5, f"k-best: first differs from MAP by {first}")
    own = geng.score_assignment(geng._labelled(ka[0, k - 1].cpu().numpy()))
    require(abs(own - float(ks[0, k - 1])) <= 1e-4 * abs(own),
            "k-best: the last of row 0 does not attain its score")
    t_k = step_ms(lambda: geng.top_k_assignments_batch(gm, k=k), iters=5)
    line.update(kbest_grid="8x8", kbest_B=Bg, k=k, kbest_step_ms=t_k,
                kbest_queries_per_s=Bg / t_k * 1e3, kbest_peak_mem_bytes=k_pk,
                kbest_first_vs_map_max_rel_err=first,
                kbest_first_assignment_equals_map=bool(
                    torch.equal(ka[ok, 0], ma[ok])))
    emit(line)


def phase_entropy_joint(dev, big, hail, path_shapes, profile):
    """``entropy_batch`` and ``joint_marginal_batch`` on the big clique: every
    big contraction launches the kernel (as many launches as the route makes
    calls on CPU meta tensors), results held to the float64 engine on the
    card, which does not use the kernel.  Then a joint of two far-apart
    variables and ``mutual_information`` on hailfinder_like (no kernel), and
    a few rows of ``entropy_batch`` on its log-sum-exp engine with the peak
    memory.  Returns {path: kernel launches of one call}."""
    import numpy as np
    import torch

    from junctiontree_tpu_torch.joint import _steiner_order_scopes

    tree, masks, names = big["tree"], big["masks"], big["names"]
    eng = tree.engine(device=dev).set_potentials(big["values"])
    ref = tree.engine(device=dev, dtype=torch.float64).set_potentials(big["values"])
    B = int(next(iter(masks.values())).shape[0])
    runs = {
        "entropy_batch": lambda e: e.entropy_batch(masks),
        "joint_marginal_batch over 2": lambda e: e.joint_marginal_batch(
            names[12:14], masks),
        "joint_marginal_batch over 3": lambda e: e.joint_marginal_batch(
            names[15:18], masks),
    }
    line = {"phase": "entropy_joint_serving", "model": "big_clique", "B": B,
            "limits": {"rtol": 1e-4, "atol": 1e-6}}
    launched = {}
    for name, run in runs.items():
        k1 = K1Counts()
        (out, z), peak = peak_bytes(lambda: run(eng))
        launched[name] = k1.launches
        require(k1.launches > 0 and k1.launches_bf16 == 0,
                f"{name}: {k1.launches} kernel launches")
        require(k1.launches == len(path_shapes[name]),
                f"{name}: {k1.launches} kernel launches, the route makes "
                f"{len(path_shapes[name])} calls on meta tensors")
        want, want_z = run(ref)
        require(out.dtype == torch.float32 and want.dtype == torch.float64,
                f"{name}: dtypes")
        require(bool(torch.isfinite(out).all()) and bool(torch.isfinite(z).all()),
                f"{name}: non-finite result")
        # row 0 is impossible evidence: H = 0 or a zero table, and Z = 0
        require(bool((out[0] == 0).all()) and float(z[0]) == 0.0,
                f"{name}: impossible row")
        np.testing.assert_allclose(out.double().cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(z.double().cpu().numpy(), want_z.cpu().numpy(),
                                   rtol=1e-4, atol=1e-30, err_msg=name + " Z")
        key = name.replace("_batch", "").replace(" over ", "")
        # steady: entropy's one derived tensor (pot log pot) is split on
        # every call, the standing potential's layouts are kept
        steady = kept_counts(lambda: run(eng))
        require(steady["splits"] <= (1 if name == "entropy_batch" else 0),
                f"{name}: a steady call made {steady}")
        line.update({
            key + "_steady_call": steady,
            key + "_kernel_launches": launched[name],
            key + "_route_calls_on_meta": len(path_shapes[name]),
            key + "_step_ms": step_ms(lambda: run(eng)),
            key + "_peak_mem_bytes": peak,
            key + "_max_abs_err_vs_f64":
                (out.double() - want).abs().max().item()})
        if profile:
            busy, n_kernels, top = profile_step(lambda: run(eng))
            line.update({key + "_device_busy_ms_per_step": busy,
                         key + "_kernels_per_step": n_kernels,
                         key + "_copy_kernels_per_step": profile_step.copies,
                         key + "_top_kernels": top[:4]})
    line["kept_layouts"] = eng.describe()["kept_layouts"]
    del ref

    # hailfinder_like, B = 128: the two variables whose Steiner subtree is
    # the longest that stays under the intermediate cap
    htree, heng, hmasks = hail["tree"], hail["eng"], hail["masks"]
    plan = htree.plan
    free = [v for v in range(plan.num_vars)
            if plan.table.label_of(v) not in hmasks]
    best = None
    for i, a in enumerate(free):
        for b in free[i + 1:]:
            try:
                order = _steiner_order_scopes(plan, [a, b], 1 << 21)[0]
            except ValueError:
                continue
            if best is None or len(order) > best[0]:
                best = (len(order), a, b)
    require(best is not None and best[0] >= 3, f"no far pair found: {best}")
    x, y = plan.table.label_of(best[1]), plan.table.label_of(best[2])
    k1 = K1Counts()
    (tables, z), peak = peak_bytes(
        lambda: heng.joint_marginal_batch([x, y], hmasks))
    rows = 16
    href = htree.engine(device=dev, dtype=torch.float64).set_potentials(
        hail["values"])
    sub = {k: v[:rows] for k, v in hmasks.items()}
    want, want_z = href.joint_marginal_batch([x, y], sub)
    require(bool((tables[1] == 0).all()) and float(z[1]) == 0.0,
            "hailfinder joint: impossible row")
    np.testing.assert_allclose(tables[:rows].double().cpu().numpy(),
                               want.cpu().numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(z[:rows].double().cpu().numpy(),
                               want_z.cpu().numpy(), rtol=1e-4, atol=1e-30)
    ev = {k: int(v[0].argmax()) for k, v in hmasks.items()}  # row 0's evidence
    mi = heng.mutual_information(x, y, ev)
    mi64 = href.mutual_information(x, y, ev)
    one, _ = heng.joint_marginal([x, y], ev)
    require(abs(mi - mi64) <= 1e-5, f"mutual information {mi} against {mi64}")
    np.testing.assert_allclose(one, tables[0].double().cpu().numpy(),
                               rtol=1e-4, atol=1e-6)
    require(k1.launches == 0, "hailfinder joints launched the kernel")
    t = step_ms(lambda: heng.joint_marginal_batch([x, y], hmasks),
                iters=3, warmup=1)
    line.update(hailfinder_joint_of=[x, y], hailfinder_steiner_cliques=best[0],
                hailfinder_B=int(z.shape[0]), hailfinder_joint_step_ms=t,
                hailfinder_joint_peak_mem_bytes=peak,
                hailfinder_joint_max_abs_err_vs_f64=(
                    tables[:rows].double() - want).abs().max().item(),
                hailfinder_rows_checked=rows, hailfinder_kernel_launches=0,
                hailfinder_mutual_information=mi,
                hailfinder_mutual_information_f64=mi64)

    # a log-sum-exp engine's entropy_batch is the per-element form under
    # torch.vmap, which holds [B, states] of every clique at once (and
    # takes the log-matmul-exp branch at hailfinder_like's scopes): a few
    # rows, against the float64 sum-product program on the same evidence
    lrows = 8
    leng = htree.engine("log_sum_exp", device=dev).set_potentials(hail["values"])
    lm = log_masks(hmasks, lrows)
    k1 = K1Counts()
    held = torch.cuda.memory_allocated()
    (lent, lz), lpeak = peak_bytes(lambda: leng.entropy_batch(lm))
    require(k1.launches == 0, "the log engine's entropy launched the kernel")
    went, wz = href.entropy_batch({k: v[:lrows] for k, v in hmasks.items()})
    require(float(lent[1]) == 0.0 and float(lz[1]) == 0.0,
            "log-sum-exp entropy: impossible row")
    require(bool(torch.isfinite(lent).all()) and bool(torch.isfinite(lz).all()),
            "log-sum-exp entropy: non-finite result")
    np.testing.assert_allclose(lent.double().cpu().numpy(), went.cpu().numpy(),
                               rtol=1e-4, atol=1e-5,
                               err_msg="log-sum-exp entropy_batch")
    np.testing.assert_allclose(lz.double().cpu().numpy(), wz.cpu().numpy(),
                               rtol=1e-4, atol=1e-30,
                               err_msg="log-sum-exp entropy_batch Z")
    t_l = step_ms(lambda: leng.entropy_batch(lm), iters=3, warmup=1)
    line.update(log_entropy_model="hailfinder_like", log_entropy_B=lrows,
                log_entropy_step_ms=t_l, log_entropy_peak_mem_bytes=lpeak,
                log_entropy_mem_held_before_bytes=held,
                log_entropy_max_abs_err_vs_f64=(
                    lent.double() - went).abs().max().item(),
                log_entropy_limits={"rtol": 1e-4, "atol": 1e-5})
    del leng, href
    emit(line)
    return launched


def tailed_big_clique_model():
    """The big clique with a two-variable tail on each of its 18 variables,
    seeded."""
    import numpy as np

    factors, sizes, values, names = big_clique_model()
    rng = np.random.default_rng(1)
    tails = [f"t{i}" for i in range(18)]
    factors = factors + [[n, t] for n, t in zip(names, tails)]
    sizes = {**sizes, **{t: 2 for t in tails}}
    values = values + [rng.random((2, 2)) + 0.1 for _ in tails]
    return factors, sizes, values, names, tails


TAILED_PATH = "incremental (tailed big clique)"


def tailed_session(B=4096):
    """The incremental session that reaches the kernel: the big clique with
    18 tails, batch B, evidence on 12 tails, a delta on one more tail and
    three query variables; with what opening it (``opened``) and opening
    plus one delta (``both``) ask of the kernel, from CPU meta tensors."""
    import numpy as np

    import junctiontree_tpu_torch as jt

    factors, sizes, values, names, tails = tailed_big_clique_model()
    tree = jt.create_junction_tree(factors, sizes)
    plan = tree.plan
    base = jt.batch_masks_sparse(
        plan, jt.random_evidence_batch(plan, B, tails[:12], seed=3))
    base[tails[0]][0] = 0.0  # row 0: impossible evidence
    upd = {tails[5]: np.tile(np.array([[0.0, 1.0]], dtype=np.float32), (B, 1))}
    qvars = [names[0], tails[17], tails[3]]
    opened = k1_calls_on_meta(plan, values, lambda e: e.incremental(base))
    both = k1_calls_on_meta(
        plan, values, lambda e: e.incremental(base).query(upd, qvars))
    require(both[:len(opened)] == opened, "opening a session is not the "
            "first part of opening it and applying a delta")
    return dict(tree=tree, values=values, B=B, base=base, upd=upd,
                qvars=qvars, opened=opened, both=both)


def check_delta(sess, eng, base, upd, qvars, what):
    """One delta against a fresh ``posterior_batch`` under the merged
    evidence (rtol 1e-5; posteriors atol 1e-6).  Returns the largest
    absolute posterior error."""
    import numpy as np
    import torch

    posts, logz = sess.query(upd, qvars)
    full, full_logz = eng.posterior_batch({**base, **upd}, mode="general")
    require(torch.equal(torch.isneginf(logz), torch.isneginf(full_logz)),
            f"{what}: -inf rows differ")
    fin = torch.isfinite(full_logz)
    np.testing.assert_allclose(logz[fin].cpu().numpy(), full_logz[fin].cpu().numpy(),
                               rtol=1e-5, err_msg=what + ": logZ")
    worst = 0.0
    for v, p in zip(qvars, posts):
        want = full[eng.plan.table.id_of(v)]
        np.testing.assert_allclose(p.cpu().numpy(), want.cpu().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{what}: posterior of {v}")
        require(bool((p[~fin] == 0).all()), f"{what}: impossible row is not zero")
        worst = max(worst, (p - want).abs().max().item())
    return worst


def phase_incremental(dev, hail, tailed):
    """Incremental sessions: hailfinder_like, B = 128 (a one-variable delta
    with three query variables beside the full step), and the big clique
    with 18 tails, B = 4096 (``tailed_session()``), whose session reaches
    the kernel: its delta is held to a fresh ``posterior_batch`` and to the
    float64 engine.  Returns the kernel launches of opening that session
    and applying one delta."""
    import numpy as np
    import torch

    tree, eng, base = hail["tree"], hail["eng"], hail["masks"]
    plan = tree.plan
    labels = [plan.table.label_of(v) for v in range(plan.num_vars)]
    B = int(next(iter(base.values())).shape[0])
    dirty = labels[1]                     # unobserved in the base evidence
    qvars = [labels[4], labels[len(labels) // 2], labels[-6]]
    upd = {dirty: np.zeros((B, plan.sizes[1]), dtype=np.float32)}
    upd[dirty][:, 0] = 1.0
    k1 = K1Counts()
    t0 = time.perf_counter()
    sess = eng.incremental(base)
    torch.cuda.synchronize()
    t_open = (time.perf_counter() - t0) * 1e3
    worst = check_delta(sess, eng, base, upd, qvars, "hailfinder delta")
    require(k1.launches == 0, "hailfinder session launched the kernel")
    merged = {**base, **upd}
    t_delta = step_ms(lambda: sess.query(upd, qvars), iters=3, warmup=1)
    t_full = step_ms(lambda: eng.posterior_batch(merged, mode="general"),
                     iters=3, warmup=1)
    line = {"phase": "incremental_serving", "model": "hailfinder_like", "B": B,
            "delta_on": dirty, "query_vars": qvars, "session_open_ms": t_open,
            "delta_step_ms": t_delta, "full_step_ms": t_full,
            "delta_over_full": t_delta / t_full, "max_abs_err_vs_full": worst,
            "limits": {"rtol": 1e-5, "posterior_atol": 1e-6}}
    del sess

    # the big clique with 18 two-variable tails: evidence on 12 tails
    ttree, values, Bt = tailed["tree"], tailed["values"], tailed["B"]
    tbase, tupd, tq = tailed["base"], tailed["upd"], tailed["qvars"]
    opened, both = tailed["opened"], tailed["both"]
    tplan = ttree.plan
    teng = ttree.engine(device=dev).set_potentials(values)
    k1 = K1Counts()
    tsess = teng.incremental(tbase)
    n_open = k1.launches
    tposts, tlogz = tsess.query(tupd, tq)
    n_delta = k1.launches - n_open
    require(n_open == len(opened) and n_delta == len(both) - len(opened),
            f"session launches {n_open} + {n_delta}, the route makes "
            f"{len(opened)} + {len(both) - len(opened)} calls on meta tensors")
    require(n_open + n_delta > 0, "the tailed big clique's session never "
            "launched the kernel")
    tworst = check_delta(tsess, teng, tbase, tupd, tq, "tailed big clique delta")
    tmerged = {**tbase, **tupd}
    # and against the float64 engine on the card, which does not use the
    # kernel, on the first rows
    rows = 256
    t64 = ttree.engine(device=dev, dtype=torch.float64).set_potentials(values)
    p64, logz64 = t64.posterior_batch(
        {k: v[:rows] for k, v in tmerged.items()}, mode="general")
    tworst64 = check_close(
        tposts, tlogz, [p64[tplan.table.id_of(v)] for v in tq], logz64,
        len(tq), "tailed big clique delta vs float64", rows=rows, **F64_LIMITS)
    del t64, p64
    t_td = step_ms(lambda: tsess.query(tupd, tq))
    t_tf = step_ms(lambda: teng.posterior_batch(tmerged, mode="general"))
    # a steady delta: the big clique at the root is multiplied by the tails'
    # unbatched messages on every call (a new tensor, split on every call
    # and handed over as a plain tensor: nothing is kept for it), and what
    # is kept for a standing potential was made on the first call
    steady = kept_counts(lambda: tsess.query(tupd, tq))
    require(steady["kept_made"] == 0,
            f"a steady session delta made {steady}")
    root = tplan.tree.root
    line.update(
        tailed_delta_steady_call=steady,
        tailed_model="big clique + 18 tails", tailed_B=Bt,
        tailed_cliques=tplan.tri.num_cliques,
        tailed_root_is_the_big_clique=len(tplan.clique_vars[root]) == 18,
        tailed_open_kernel_launches=n_open,
        tailed_delta_kernel_launches=n_delta,
        tailed_open_route_calls_on_meta=len(opened),
        tailed_delta_route_calls_on_meta=len(both) - len(opened),
        tailed_delta_step_ms=t_td, tailed_full_step_ms=t_tf,
        tailed_max_abs_err_vs_full=tworst,
        tailed_max_abs_err_vs_f64=tworst64, tailed_rows_checked_vs_f64=rows,
        tailed_limits_vs_f64=F64_LIMITS,
        note="with the big clique at the root its collect message does not "
             "exist, so opening launches nothing there and the delta's Z, "
             "distribute and marginal contractions do; with a tail at the "
             "root the big clique's collect message launches at opening")
    emit(line)
    return n_open + n_delta


def phase_surgery(dev, big, hail):
    """``multiply_factor`` on the big clique against an engine built on
    ``surgery.add_factor``'s plan, a ``save`` / ``load(device=...)`` round
    trip, and ``max_feasible_batch`` beside hailfinder_like's measured peak."""
    import os
    import tempfile

    import numpy as np
    import torch

    import junctiontree_tpu_torch as jt

    tree, masks, names = big["tree"], big["masks"], big["names"]
    plan = tree.plan
    scope = [names[16], names[13]]  # two unobserved variables, unsorted
    val = np.random.default_rng(5).random((2, 2)) + 0.1
    eng = jt.Engine(plan, device=dev).set_potentials(big["values"])
    before, _ = eng.posterior_batch(masks)
    k1 = K1Counts()
    eng.multiply_factor(scope, val)
    post, logz = eng.posterior_batch(masks)
    launches = k1.launches
    plan2, covered = jt.add_factor(plan, scope)
    require(covered and plan2.tree is plan.tree, "add_factor: scope not covered")
    grown = jt.Engine(plan2, device=dev).set_potentials(big["values"] + [val])
    want, want_logz = grown.posterior_batch(masks)
    worst = check_close(post, logz, want, want_logz, len(post),
                        "multiply_factor vs add_factor", rtol=1e-5, atol=1e-6,
                        logz_atol=1e-4)
    moved = max((a - b).abs().max().item() for a, b in zip(post, before))
    require(moved > 1e-3, "multiply_factor did not change the posteriors")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "engine.npz")
        eng.save(path)
        size = os.path.getsize(path)
        back = jt.Engine.load(path, device=dev)
    require(back.device == dev and back.plan.to_json() == plan.to_json(),
            "load: device or plan")
    bpost, blogz = back.posterior_batch(masks)
    require(torch.equal(blogz, logz)
            and all(torch.equal(a, b) for a, b in zip(bpost, post)),
            "a loaded engine's posteriors are not bitwise equal")
    heng = hail["eng"]
    total = torch.cuda.get_device_properties(dev).total_memory
    analysis = {"batch": hail["B"], "temp_bytes": hail["peak"]}
    emit({"phase": "surgery_checkpoint", "model": "big_clique",
          "multiply_factor_scope": scope, "kernel_launches": launches,
          "max_abs_err_vs_add_factor_engine": worst,
          "max_posterior_change": moved, "checkpoint_bytes": size,
          "loaded_bitwise_equal": True,
          "limits": {"rtol": 1e-5, "atol": 1e-6, "logz_atol": 1e-4},
          "hailfinder_B": hail["B"], "hailfinder_peak_mem_bytes": hail["peak"],
          "hailfinder_max_feasible_batch_default": heng.max_feasible_batch(),
          "hailfinder_max_feasible_batch_card": heng.max_feasible_batch(
              budget_bytes=total),
          "hailfinder_max_feasible_batch_from_measured_peak":
              heng.max_feasible_batch(budget_bytes=total, analysis=analysis),
          "card_total_memory_bytes": total,
          "describe_kernel_launches": eng.describe()["kernel_launches"]})


LEARN_BIG = "fit_mle_missing step (big clique)"
LEARN_FWD = "expected_counts forward (tailed big clique)"
LEARN_BWD = "expected_counts backward (tailed big clique)"
LEARN_PATHS = (LEARN_BIG, LEARN_FWD, LEARN_BWD)


def missing_data(plan, values, N, hidden, seed, dev):
    """[N, num_vars] exact samples of the model, drawn on the card, with the
    ``hidden`` var ids missing (-1)."""
    import numpy as np

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.sampling import engine_sample

    eng = jt.Engine(plan, device=dev).set_potentials(values)
    data = np.array(engine_sample(eng, seed, N), dtype=np.int64)
    data[:, hidden] = -1
    return data


def k1_learning_calls_on_meta(plan, values, N):
    """What one E-step (logZ of N evidence rows and its gradient) asks of
    the kernel, from a run on meta tensors: (R1, R2, C, B), the strides of
    the potential as it is handed over, and whether the backward pass made
    the call, in order."""
    import torch

    from junctiontree_tpu_torch import learn
    from junctiontree_tpu_torch.ops import factored_contract as fc

    calls = []
    inner = fc._contract_on_device

    def record(pot, w1, w2, backward=False, precision="highest"):
        calls.append((tuple(int(d) for d in pot.shape) + (int(w1.shape[0]),),
                      tuple(pot.stride()), backward))
        return inner(pot, w1, w2, backward, precision)

    meta = torch.device("meta")
    masks = [torch.empty((N, n), device=meta) for n in plan.sizes]
    fc._contract_on_device = record
    try:
        learn._e_step(learn._obs_logz_program(plan), values, masks, meta,
                      torch.float32)
    finally:
        fc._contract_on_device = inner
    return calls


def learning_models(N=4096):
    """The two big-clique learning problems: the model, the 6 of its 18
    clique columns that the data will miss, and the kernel calls of one
    E-step on N rows, from meta tensors."""
    import junctiontree_tpu_torch as jt

    out = {}
    for name, model in (("big", big_clique_model()),
                        ("tailed", tailed_big_clique_model())):
        factors, sizes, values, names = model[:4]
        plan = jt.compile_plan(factors, sizes)
        hidden = [plan.table.id_of(n) for n in names[::3]]
        out[name] = dict(plan=plan, values=values, hidden=hidden, N=N,
                         calls=k1_learning_calls_on_meta(plan, values, N))
    return out


def phase_kernel_backward(dev, device_ms, host_us):
    """The gradients of the kernel's autograd Function at the two serving
    shapes: against ``torch.autograd.grad`` of the plain version (1e-5 of
    max|grad|), two runs bitwise equal, and the device time of each piece
    (dw1 and dw2: the kernel on a permuted potential; dpot: one matrix
    product) beside its bound, the plain version's and one ``einsum``'s."""
    import torch

    from junctiontree_tpu_torch.ops import factored_contract as fc

    k1 = fc.factored_masked_contract
    g = torch.Generator(device=dev).manual_seed(1)
    for R1, R2, C, B in ((64, 2048, 2, 4096), (64, 4096, 1, 4096)):
        # the potential in the layout the route hands over
        pot = torch.rand((R2, R1, C), generator=g, device=dev).permute(1, 0, 2)
        w1 = torch.rand((B, R1), generator=g, device=dev)
        w2 = torch.rand((B, R2), generator=g, device=dev)
        up = torch.rand((B, C), generator=g, device=dev)

        def grads(fn):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (pot, w1, w2)]
            out = fn(*leaves)
            require(out.grad_fn is not None, "an output without grad_fn")
            return torch.autograd.grad(out, leaves, up)

        n = K1Counts()
        got = grads(k1)
        torch.cuda.synchronize()
        require(n.launches == 3 and n.launches_backward == 2,
                f"backward: {n.launches} launches, {n.launches_backward} "
                "of them backward; expected 3 and 2")
        splits = n.splits
        want = grads(fc.reference_factored_contract)
        errs = {}
        for name, a, b in zip(("dpot", "dw1", "dw2"), got, want):
            errs[name] = ((a - b).abs().max() / b.abs().max()).item()
            require(errs[name] <= 1e-5,
                    f"{name} disagrees at {(R1, R2, C, B)}: {errs[name]}")
        for a, b in zip(got, grads(k1)):
            require(torch.equal(a, b), "two backward runs differ")
        ein = lambda p, a, b: torch.einsum("rsc,br,bs->bc", p, a, b)
        for a, b in zip(grads(ein), want):
            require(((a - b).abs().max() / b.abs().max()).item() <= 1e-4,
                    "einsum's gradient disagrees with the plain version's")
        none = fc._contract_on_device

        def g_as_w2(c=none):
            """The other assignment: g in w2's place, an inner loop of C.
            No path takes it, and its w2 rows (C floats) are too short for
            the Tensor Memory Accelerator: the copy is not a serving
            path's, so it is not counted."""
            n = K1Counts()
            try:
                return c(pot.permute(0, 2, 1), w1, up)
            finally:
                take_back("factored_masked_contract.padded", n.padded)

        pieces = {
            "dw1": lambda c=none: c(pot.permute(2, 1, 0), up, w2),
            "dw2": lambda c=none: c(pot.permute(2, 0, 1), up, w1),
            "dw2_g_as_w2": g_as_w2,
        }
        ref = fc.reference_factored_contract
        line = {"phase": "kernel_backward_vs_plain", "R1": R1, "R2": R2,
                "C": C, "B": B, "dtype": "float32", "rel_err": errs,
                "tol": 1e-5, "bitwise_repeatable": True}
        alt = pieces["dw2_g_as_w2"]()
        require(((alt - want[2]).abs().max() / want[2].abs().max()).item()
                <= 1e-5, "dw2 with g as w2 disagrees")
        # the one PyTorch call for each kernel piece's function, and the two
        # library products of library_factored_contract: yardsticks only
        # (dpot is a library product already)
        library = {
            "dw1": lambda: torch.einsum("rsc,bc,bs->br", pot, up, w2),
            "dw2": lambda: torch.einsum("rsc,br,bc->bs", pot, w1, up),
        }
        line["pot_splits_fwd_bwd"] = splits
        for name, fn in pieces.items():
            line[name + "_ms"] = device_ms(fn)
            line[name + "_plain_ms"] = device_ms(lambda: fn(ref))
            line[name + "_library_factored_ms"] = device_ms(
                lambda: fn(fc.library_factored_contract))
        for name in ("dw1", "dw2"):
            p3, a, b = {"dw1": (pot.permute(2, 1, 0), up, w2),
                        "dw2": (pot.permute(2, 0, 1), up, w1)}[name]
            line[name + "_split"] = split_line(p3, a, b)
        line["dpot_ms"] = device_ms(lambda: fc._contract_grads(
            None, pot, w1, w2, up, (True, False, False)))
        for name, fn in library.items():
            line[name + "_library_ms"] = device_ms(fn)
        # the least time of one piece (each a contraction of the same
        # operations and bytes), f32 work at six bf16 passes' rate
        line["piece_bound_ms"], line["piece_bound_by"] = kernel_bound_ms(
            R1, R2, C, B, False)
        # forward and backward together on standing leaves: the Function,
        # the plain version under autograd, one einsum under autograd; the
        # spin is long enough for the slowest host side of the three
        leaves = [t.detach().clone().requires_grad_(True) for t in (pot, w1, w2)]
        for name, fn in (("function", k1), ("plain", ref), ("einsum", ein)):
            both = lambda: torch.autograd.grad(fn(*leaves), leaves, up)
            line[name + "_fwd_bwd_ms"] = device_ms(
                both, iters=10, spin_cycles=100_000_000)
            line[name + "_fwd_bwd_host_us"] = host_us(both, iters=50)
        line["fwd_bwd_bound_ms"] = 4 * line["piece_bound_ms"]
        emit(line)


def chain_samples(plan, values, N, seed):
    """[N, n] ancestral samples of ``chain_bn_model``'s chain (``values[0]``
    over x0, ``values[i]`` the table of (x_{i-1}, x_i)), by var id."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = plan.num_vars
    data = np.zeros((N, n), dtype=np.int64)
    p0 = np.asarray(values[0], dtype=np.float64)
    col = (rng.random(N)[:, None] > np.cumsum(p0 / p0.sum())[None, :-1]).sum(axis=1)
    data[:, plan.table.id_of("x0")] = col
    for i in range(1, n):
        t = np.asarray(values[i], dtype=np.float64)
        cum = np.cumsum(t / t.sum(axis=-1, keepdims=True), axis=-1)
        col = (rng.random(N)[:, None] > cum[col][:, :-1]).sum(axis=1)
        data[:, plan.table.id_of(f"x{i}")] = col
    return data


def phase_learning(dev, learn_models, chain, profile):
    """Learning on the card.  (a) ``expected_counts`` on the big clique and
    on the big clique with tails, N = 4096 rows with 6 of 18 clique columns
    missing: held to the same call in float64 on the card (the plain
    version; rtol 1e-4), kernel launches forward and backward equal to the
    calls counted on meta tensors; then 3 steps of ``fit_mle_missing`` with a
    rising likelihood.  (b) ``fit_mle_chain`` on the 5,000-chain, N = 1024, 3
    steps.  (c) ``expected_counts`` on hailfinder_like, N = 32: the einsum
    route under autograd.  Returns {path: kernel launches}."""
    import numpy as np
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch import learn
    from junctiontree_tpu_torch.learn_chain import fit_mle_chain
    from junctiontree_tpu_torch.models import hailfinder_like

    line = {"phase": "learning", "limits": {"rtol": 1e-4, "atol": 1e-3}}
    launched = {}
    for name, lm in learn_models.items():
        plan, values = lm["plan"], lm["values"]
        data = missing_data(plan, values, lm["N"], lm["hidden"], 7, dev)
        masks = learn.masks_from_data(plan, data)
        fwd = sum(1 for c in lm["calls"] if not c[2])
        bwd = sum(1 for c in lm["calls"] if c[2])
        k1 = K1Counts()
        counts, peak = peak_bytes(
            lambda: learn.expected_counts(plan, values, masks, device=dev))
        n_fwd, n_bwd = k1.launches - k1.launches_backward, k1.launches_backward
        require((n_fwd, n_bwd) == (fwd, bwd),
                f"learning ({name}): {n_fwd} forward and {n_bwd} backward "
                f"kernel launches, {fwd} and {bwd} calls on meta tensors")
        require(n_fwd > 0, f"learning ({name}) never launched the kernel")
        want = learn.expected_counts(plan, values, masks, device=dev,
                                     dtype=torch.float64)
        require(k1.launches == n_fwd + n_bwd,
                "the float64 run launched the float32 kernel")
        worst = 0.0
        for c, w in zip(counts, want):
            require(np.isfinite(c).all(), "non-finite expected counts")
            np.testing.assert_allclose(c, w, rtol=1e-4, atol=1e-3,
                                       err_msg=f"expected_counts ({name})")
            worst = max(worst, float(np.abs(c - w).max()))
        require(abs(counts[0].sum() - len(data)) <= 1e-3 * len(data),
                "expected counts of a factor do not sum to N")
        t = step_ms(lambda: learn.expected_counts(plan, values, masks, device=dev),
                    iters=5, warmup=1)
        k1 = K1Counts()
        steps = 3
        t0 = time.perf_counter()
        thetas, hist = learn.fit_mle_missing(plan, data, steps=steps, device=dev)
        torch.cuda.synchronize()
        t_fit = (time.perf_counter() - t0) * 1e3 / steps
        require(all(b > a for a, b in zip(hist, hist[1:])),
                f"fit_mle_missing ({name}): the likelihood does not rise: {hist}")
        require(k1.launches == steps * (fwd + bwd)
                and k1.launches_backward == steps * bwd,
                f"fit_mle_missing ({name}): {k1.launches} launches in {steps} steps")
        require(all(np.isfinite(t_).all() for t_ in thetas), "non-finite thetas")
        if name == "big":
            launched[LEARN_BIG] = k1.launches // steps
        else:
            launched[LEARN_FWD], launched[LEARN_BWD] = n_fwd, n_bwd
        line.update({
            name + "_N": len(data), name + "_cliques": plan.tri.num_cliques,
            name + "_kernel_launches_forward": n_fwd,
            name + "_kernel_launches_backward": n_bwd,
            name + "_calls_on_meta": [fwd, bwd],
            name + "_expected_counts_ms": t,
            name + "_expected_counts_peak_mem_bytes": peak,
            name + "_max_abs_err_vs_f64": worst,
            name + "_fit_step_ms": t_fit, name + "_loglik": hist})
        if profile:
            busy, n_kernels, top = profile_step(
                lambda: learn.expected_counts(plan, values, masks, device=dev))
            line.update({name + "_device_busy_ms_per_step": busy,
                         name + "_kernels_per_step": n_kernels,
                         name + "_top_kernels": top[:4]})

    # (b) the chain learner on the 5,000-chain
    ctree, cvalues = chain
    cplan = ctree.plan
    n, N = cplan.num_vars, 1024
    cdata = chain_samples(cplan, cvalues, N, seed=3)
    cdata[np.random.default_rng(3).random(cdata.shape) < 0.1] = -1
    k1 = K1Counts()
    t0 = time.perf_counter()
    (cth, chist), cpeak = peak_bytes(
        lambda: fit_mle_chain(cplan, cdata, steps=3, device=dev))
    t_chain = (time.perf_counter() - t0) * 1e3 / 3
    require(all(b > a for a, b in zip(chist, chist[1:])),
            f"fit_mle_chain: the likelihood does not rise: {chist}")
    require(len(cth) == len(cplan.factors) and k1.launches == 0, "fit_mle_chain")
    line.update(chain_variables=n, chain_N=N, chain_step_ms=t_chain,
                chain_peak_mem_bytes=cpeak, chain_loglik=chist)

    # (c) hailfinder_like: the einsum route under autograd
    factors, sizes, values = hailfinder_like(seed=0)
    hplan = jt.compile_plan(factors, sizes)
    Nh = 32
    hdata = np.stack([np.random.default_rng(9).integers(0, n_, Nh)
                      for n_ in hplan.sizes], axis=1)
    hdata[:, 1::3] = -1
    hmasks = learn.masks_from_data(hplan, hdata)
    obs_logz = learn._obs_logz_program(hplan)
    dmasks = [torch.as_tensor(m, device=dev) for m in hmasks]
    thetas = [torch.log(torch.as_tensor(v, dtype=torch.float32, device=dev)
                        .clamp_min(1e-38)) for v in values]
    with torch.no_grad():
        logz, fwd_peak = peak_bytes(lambda: obs_logz(thetas, dmasks))
    del logz
    k1 = K1Counts()
    hcounts, hpeak = peak_bytes(
        lambda: learn.expected_counts(hplan, values, hmasks, device=dev))
    require(k1.launches == 0, "hailfinder learning launched the kernel")
    rows = 4
    hwant = learn.expected_counts(hplan, values, [m[:rows] for m in hmasks],
                                  device=dev, dtype=torch.float64)
    hsub = learn.expected_counts(hplan, values, [m[:rows] for m in hmasks],
                                 device=dev)
    hworst = 0.0
    for c, w in zip(hsub, hwant):
        np.testing.assert_allclose(c, w, rtol=1e-4, atol=1e-4,
                                   err_msg="expected_counts (hailfinder_like)")
        hworst = max(hworst, float(np.abs(c - w).max()))
    require(all(abs(c.sum() - Nh) <= 1e-3 * Nh for c in hcounts),
            "hailfinder expected counts do not sum to N")
    t_h = step_ms(lambda: learn.expected_counts(hplan, values, hmasks, device=dev),
                  iters=2, warmup=0)
    if profile:
        busy, n_kernels, top = profile_step(
            lambda: learn.expected_counts(hplan, values, hmasks, device=dev),
            steps=2)
        line.update(hailfinder_device_busy_ms_per_step=busy,
                    hailfinder_kernels_per_step=n_kernels,
                    hailfinder_top_kernels=top[:4])
    line.update(hailfinder_N=Nh, hailfinder_expected_counts_ms=t_h,
                hailfinder_peak_mem_bytes=hpeak,
                hailfinder_forward_only_peak_mem_bytes=fwd_peak,
                hailfinder_max_abs_err_vs_f64=hworst,
                hailfinder_rows_checked=rows, hailfinder_kernel_launches=0)
    emit(line)
    return launched


def strong_tree_samples(n_vars, N, seed):
    """Ancestral samples [N, n_vars] of a random tree BN with strongly
    coupled CPDs (cards 2 and 3), and its undirected edges."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cards = [2 + (v % 2) for v in range(n_vars)]
    parent = {v: int(rng.integers(0, v)) for v in range(1, n_vars)}
    data = np.zeros((N, n_vars), dtype=np.int64)
    data[:, 0] = rng.integers(0, cards[0], N)
    for v in range(1, n_vars):
        p = parent[v]
        cpd = rng.random((cards[p], cards[v])) * 0.2
        for i in range(cards[p]):
            cpd[i, i % cards[v]] += 2.0
        cum = np.cumsum(cpd / cpd.sum(axis=1, keepdims=True), axis=1)
        data[:, v] = (rng.random(N)[:, None] > cum[data[:, p]]).sum(axis=1)
    return data, cards, {frozenset((p, v)) for v, p in parent.items()}


def phase_solvers(dev, hail, profile):
    """The solvers beside the engine, each at a size of the JAX package's
    own benchmark and held to a reference."""
    import numpy as np
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.models import grid_mrf_model, sprinkler_model
    from junctiontree_tpu_torch.sampling import engine_sample

    line = {"phase": "solvers"}
    k1 = K1Counts()

    # Marginal MAP: 6x6 grid, 6 MAP variables, B = 2048, against float64
    factors, sizes, values = grid_mrf_model(6, 6, seed=0)
    names = list(sizes)
    map_vars = names[::7][:6]
    B = 2048
    rng = np.random.default_rng(4)
    obs = [v for v in names if v not in map_vars][:4]
    masks = {}
    for v in obs:
        m = np.full((B, sizes[v]), -1e30, dtype=np.float32)
        m[np.arange(B), rng.integers(0, sizes[v], size=B)] = 0.0
        masks[v] = m
    masks[obs[0]][5] = -np.inf  # row 5: no state of this variable allowed
    solver = jt.MarginalMapSolver(factors, sizes, map_vars, device=dev)
    solver.set_potentials(values)
    (assign, score), peak = peak_bytes(lambda: solver.query_batch(masks))
    ref = jt.MarginalMapSolver(factors, sizes, map_vars, device=dev,
                               dtype=torch.float64).set_potentials(values)
    rassign, rscore = ref.query_batch(masks)
    require(assign.dtype == torch.int32 and tuple(assign.shape) == (B, 6),
            "MMAP assignment")
    require(float(score[5]) < -1e29 and not bool(torch.isnan(score).any()),
            "MMAP: the infeasible row does not score below -1e29")
    ok = rscore > -1e29
    err = ((score.double() - rscore)[ok].abs() / rscore[ok].abs()).max().item()
    require(err <= 1e-5, f"MMAP scores differ from float64 by {err}")
    same = float((assign[ok] == rassign[ok]).all(dim=1).double().mean())
    require(same >= 0.99, f"MMAP assignments equal float64's on {same} of rows")
    t = step_ms(lambda: solver.query_batch(masks), iters=5, warmup=1)
    line.update(mmap_grid="6x6", mmap_B=B, mmap_map_vars=len(map_vars),
                mmap_constrained_width=solver.constrained_width,
                mmap_step_ms=t, mmap_queries_per_s=B / t * 1e3,
                mmap_peak_mem_bytes=peak, mmap_max_rel_err_vs_f64=err,
                mmap_rows_with_f64_assignment=same)
    if profile:
        busy, n_kernels, _ = profile_step(lambda: solver.query_batch(masks))
        line.update(mmap_device_busy_ms_per_step=busy,
                    mmap_kernels_per_step=n_kernels)
    del solver, ref

    # cutset conditioning on hailfinder_like, B = 1024, against the engine
    hf, hs, hv = hail["factors"], hail["sizes"], hail["values"]
    hnames = list(hs)
    Bc, rows = 1024, 128
    rng = np.random.default_rng(0)
    cmasks = {}
    for v in hnames[::5]:
        m = np.zeros((Bc, hs[v]), dtype=np.float32)
        m[np.arange(Bc), rng.integers(0, hs[v], Bc)] = 1.0
        cmasks[v] = m
    t0 = time.perf_counter()
    ce = jt.CutsetEngine(hf, hs, hv, target_states=1 << 14, max_enum=512,
                         device=dev)
    build = time.perf_counter() - t0
    require(len(ce.cutset) > 0, "the cutset is empty")
    cmasks[hnames[0]][3] = 0.0              # row 3: impossible, reduced variable
    on_cut = np.ones((Bc, hs[ce.cutset[0]]), dtype=np.float32)
    on_cut[7] = 0.0                         # row 7: impossible, cutset variable
    cmasks[ce.cutset[0]] = cmasks.get(ce.cutset[0], 1.0) * on_cut
    st = ce.describe()
    chunk = ce._chunk_for(Bc)
    torch.cuda.empty_cache()
    (cposts, clogz), cpeak = peak_bytes(lambda: ce.posterior_batch(cmasks))
    t_c = step_ms(lambda: ce.posterior_batch(cmasks), iters=2, warmup=0)
    eposts, elogz = hail["eng"].posterior_batch(
        {k: v[:rows] for k, v in cmasks.items()})
    plan = hail["tree"].plan
    require(bool(torch.isneginf(clogz[3])) and bool(torch.isneginf(clogz[7]))
            and bool(torch.isneginf(elogz[3])) and bool(torch.isneginf(elogz[7])),
            "cutset: impossible rows are not -inf")
    cworst = check_close(
        [cposts[plan.table.label_of(v)] for v in range(plan.num_vars)], clogz,
        eposts, elogz, plan.num_vars, "cutset vs engine", rows=rows,
        rtol=1e-3, atol=1e-5, logz_atol=1e-3)
    line.update(
        cutset_model="hailfinder_like", cutset_B=Bc, cutset=st["cutset"],
        cutset_states=st["cutset_states"], cutset_build_s=build,
        cutset_reduced_max_clique_states=st["max_clique_states"],
        cutset_reduced_total_clique_states=st["total_clique_states"],
        cutset_chunk=chunk, cutset_chunk_budget_bytes=ce._chunk_budget,
        cutset_reckoned_bytes_per_chunk=4 * Bc * st["total_clique_states"] * 2 * chunk,
        cutset_peak_mem_bytes=cpeak, cutset_step_ms=t_c,
        cutset_queries_per_s=Bc / t_c * 1e3,
        cutset_max_abs_err_vs_engine=cworst, cutset_rows_checked=rows,
        cutset_limits={"rtol": 1e-3, "atol": 1e-5, "logz_atol": 1e-3})
    if profile:
        busy, n_kernels, top = profile_step(
            lambda: ce.posterior_batch(cmasks), steps=1)
        line.update(cutset_device_busy_ms_per_step=busy,
                    cutset_kernels_per_step=n_kernels,
                    cutset_top_kernels=top[:4])
    del ce, cposts, eposts
    torch.cuda.empty_cache()

    # loopy BP: 30x30 grid, 100 iterations, B = 256, against its CPU run
    factors, sizes, values = grid_mrf_model(30, 30, coupling=0.3, seed=0)
    Bl, lrows = 256, 8
    rng = np.random.default_rng(1)
    lmasks = {}
    for v in list(sizes)[:100]:
        m = np.zeros((Bl, 2), dtype=np.float32)
        m[np.arange(Bl), rng.integers(0, 2, Bl)] = 1.0
        lmasks[v] = m
    settings = dict(damping=0.5, max_iters=100, tol=0.0, chunk_iters=100)
    leng = jt.LoopyEngine(factors, sizes, values, device=dev, **settings)
    (lposts, llogz, info), lpeak = peak_bytes(lambda: leng.posterior_batch(lmasks))
    require(info["iters"] == 100 and bool(torch.isfinite(llogz).all()), "loopy BP")
    cpu = jt.LoopyEngine(factors, sizes, values, device="cpu", **settings)
    wposts, wlogz, _ = cpu.posterior_batch({k: v[:lrows] for k, v in lmasks.items()})
    lerr = max((lposts[v][:lrows].cpu() - wposts[v]).abs().max().item()
               for v in range(leng.num_vars))
    lz_err = ((llogz[:lrows].cpu() - wlogz).abs() / wlogz.abs()).max().item()
    require(lerr <= 1e-4 and lz_err <= 1e-4,
            f"loopy BP differs from its CPU run: {lerr}, logZ {lz_err}")
    t_l = step_ms(lambda: leng.posterior_batch(lmasks), iters=3, warmup=1)
    line.update(loopy_grid="30x30", loopy_B=Bl, loopy_iters=info["iters"],
                loopy_delta=info["delta"], loopy_step_ms=t_l,
                loopy_queries_per_s=Bl / t_l * 1e3, loopy_peak_mem_bytes=lpeak,
                loopy_max_abs_err_vs_cpu=lerr, loopy_max_rel_logz_err_vs_cpu=lz_err,
                loopy_rows_checked=lrows, loopy_limits={"atol": 1e-4})
    if profile:
        busy, n_kernels, _ = profile_step(
            lambda: leng.posterior_batch(lmasks), steps=2)
        line.update(loopy_device_busy_ms_per_step=busy,
                    loopy_kernels_per_step=n_kernels)
    del leng

    # 100,000 exact samples of the sprinkler network
    f, s, v = sprinkler_model()
    stree = jt.create_junction_tree(f, s)
    seng = stree.engine(device=dev).set_potentials(v)
    n = 100_000
    t0 = time.perf_counter()
    draws = engine_sample(seng, 11, n, evidence={"wet_grass": 1})
    t_s = (time.perf_counter() - t0) * 1e3
    require(np.array_equal(draws, engine_sample(seng, 11, n, {"wet_grass": 1})),
            "two sample runs from one seed differ")
    post, _ = seng.query({"wet_grass": 1})
    worst_se = 0.0
    for vid in range(stree.plan.num_vars):
        p = float(post[vid][1])
        se = max(np.sqrt(p * (1 - p) / n), 1e-9)
        worst_se = max(worst_se, abs(draws[:, vid].mean() - p) / se)
    require(worst_se <= 3.0,
            f"sample frequencies are {worst_se} standard errors off")
    line.update(samples=n, sampling_ms=t_s, samples_worst_standard_errors=worst_se,
                samples_seeded_twice_equal=True)

    # Chow-Liu on samples of a tree
    data, cards, edges = strong_tree_samples(40, 50_000, seed=5)
    t0 = time.perf_counter()
    cf, cs_, cv, cedges = jt.chow_liu(data, cards=cards, device=dev)
    t_cl = (time.perf_counter() - t0) * 1e3
    require({frozenset(e) for e in cedges} == edges,
            "chow_liu did not recover the tree")
    line.update(chow_liu_vars=40, chow_liu_N=50_000, chow_liu_ms=t_cl,
                chow_liu_recovered=True)
    require(k1.launches == 0, "a solver launched the big-clique kernel")
    emit(line)


def phase_autotune(dev, tree, values, masks, main_shapes):
    """The kernel measured against the library on the card: one decision
    per distinct shape of the big clique's ``posterior_batch`` in float32
    and bfloat16 (the kernel's and the library's time, the winner, the
    margin, and whether the entry was measured now or read back), then one
    ``posterior_batch`` in each dtype with the table filled: every
    contraction launches the kernel whatever the table says, and the
    result is held to float64."""
    import torch

    from junctiontree_tpu_torch.config import DEFAULT
    from junctiontree_tpu_torch.ops import autotune

    require(DEFAULT.autotune, "measurement is off by default")
    name = torch.cuda.get_device_name(dev)
    for R1, R2, C, B in sorted(set(main_shapes)):
        for dt in ("f32", "bf16"):
            key = f"{dt}:{R1}x{R2}x{C}:B{B}:{name}"
            had = key in autotune.report()
            winner = autotune.decide(R1, R2, C, B, dtype=dt, device=dev)
            ent = autotune.report()[key]
            again = autotune.decide(R1, R2, C, B, dtype=dt, device=dev)
            require(again == winner, "a validated decision changed")
            emit({"phase": "autotune", "R1": R1, "R2": R2, "C": C, "B": B,
                  "dtype": dt, "winner": winner, "margin": ent["margin"],
                  "k1_ms": ent["k1_ms"], "library_ms": ent["library_ms"],
                  "k1_device_ms": ent["k1_device_ms"],
                  "library_device_ms": ent["library_device_ms"],
                  "bound_ms": ent["bound_ms"], "bound_by": ent["bound_by"],
                  "entry": "read back" if had else "measured now",
                  "second_call": "validated in this process"})
    rows = 64
    ref = tree.engine(device=dev, dtype=torch.float64).set_potentials(values)
    ref_post, ref_logz = ref.posterior_batch(
        {k: v[:rows] for k, v in masks.items()})
    for dtype in (torch.float32, torch.bfloat16):
        eng = tree.engine(device=dev, dtype=dtype).set_potentials(values)
        k1 = K1Counts()
        post, logz = eng.posterior_batch(masks)
        n_k1 = k1.launches
        require(n_k1 == len(main_shapes),
                f"with the table filled: {n_k1} kernel launches, "
                f"expected {len(main_shapes)}")
        limits = (F64_LIMITS if dtype == torch.float32
                  else dict(rtol=0, atol=0.02, logz_atol=0.05))
        worst = check_close(post, logz, ref_post, ref_logz, len(post),
                            f"{dtype} with the table filled vs float64", rows=rows, **limits)
        emit({"phase": "autotune", "path": "posterior_batch (big clique)",
              "dtype": str(dtype).split(".")[-1], "B": int(logz.shape[0]),
              "kernel_launches": n_k1, "max_abs_err_vs_f64": worst,
              "rows_checked": rows, "limits": limits})
        del eng, post


def hailfinder_serving(dev, B=128):
    """hailfinder_like with B rows of evidence on every third variable (row
    1 impossible), its float32 engine, and float64 posteriors of the first
    16 rows."""
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.models import hailfinder_like

    factors, sizes, values = hailfinder_like(seed=0)
    tree = jt.create_junction_tree(factors, sizes)
    plan = tree.plan
    labels = [plan.table.label_of(v) for v in range(plan.num_vars)][::3]
    masks = jt.batch_masks_sparse(
        plan, jt.random_evidence_batch(plan, B, labels, seed=2))
    masks[labels[0]][1] = 0.0  # row 1: impossible evidence
    eng = tree.engine(device=dev).set_potentials(values)
    rows = 16
    ref = tree.engine(device=dev, dtype=torch.float64).set_potentials(values)
    ref_post, ref_logz = ref.posterior_batch(
        {k: v[:rows] for k, v in masks.items()})
    del ref
    torch.cuda.empty_cache()
    return dict(tree=tree, factors=factors, sizes=sizes, values=values,
                labels=labels, masks=masks, eng=eng, B=B, rows=rows,
                ref_post=ref_post, ref_logz=ref_logz)


def phase_precision(dev, hail):
    """A process that allows TF32 (``torch.set_float32_matmul_precision(
    "high")``) still gets float64-grade posteriors from hailfinder_like's
    planned einsums, and keeps its own setting."""
    import torch

    eng, masks = hail["eng"], hail["masks"]
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        post, logz = eng.posterior_batch(masks)
        torch.cuda.synchronize()
        after = torch.get_float32_matmul_precision()
        tf32 = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved)
    require(after == "high" and tf32, f"the caller's precision became {after}")
    worst = check_close(post, logz, hail["ref_post"], hail["ref_logz"], len(post),
                        "hailfinder_like with TF32 allowed vs float64",
                        rows=hail["rows"], **F64_LIMITS)
    emit({"phase": "precision", "model": "hailfinder_like", "B": hail["B"],
          "caller_precision": "high", "caller_precision_after": after,
          "package_precision": "highest", "max_abs_err_vs_f64": worst,
          "rows_checked": hail["rows"], "limits": F64_LIMITS})


def phase_native_compile():
    """The plans of the 1,000-leaf star and the 5,000-chain from the Python
    compiler and from ``backend="auto"`` (the C++ compiler from 512
    variables up): equal ``Plan.to_json()``, and each one's seconds."""
    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch import native
    from junctiontree_tpu_torch.models import chain_bn_model, star_bn_model

    t0 = time.perf_counter()
    require(native.available(), "the native compiler did not build")
    build = time.perf_counter() - t0
    line = {"phase": "native_compile", "g++_build_and_load_s": build}
    for name, (f, s, _) in (("star1000", star_bn_model(1000, card=3)),
                            ("chain5000", chain_bn_model(5000, seed=1))):
        t0 = time.perf_counter()
        py = jt.compile_plan(f, s, backend="python").to_json()
        t_py = time.perf_counter() - t0
        t0 = time.perf_counter()
        auto = jt.compile_plan(f, s).to_json()
        t_auto = time.perf_counter() - t0
        require(py == auto, f"{name}: the native plan differs from the Python plan")
        line.update({f"{name}_python_s": t_py, f"{name}_auto_native_s": t_auto})
    emit(line)


def phase_cli(dev, big):
    """``python -m junctiontree_tpu_torch`` in process on the card: the big
    clique and one evidence row as UAI files, tasks MAR and PR, every
    big-clique contraction launching the kernel, the printed numbers held
    to an in-process float64 engine."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch import __main__ as cli
    from junctiontree_tpu_torch.ops import factored_contract as fc
    from junctiontree_tpu_torch.utils.uai import load_uai, write_uai

    names = big["names"]
    ids = {n: i for i, n in enumerate(names)}
    ev = {ids[n]: int(st) for n, st in
          jt.random_evidence_batch(big["tree"].plan, 1, names[:12], seed=7)[0].items()}
    line = {"phase": "cli", "model": "big_clique", "B": 1, "observed": len(ev)}
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "big.uai")
        with open(model, "w") as f:
            f.write(write_uai([[ids[v] for v in fv] for fv in big["factors"]],
                              {i: 2 for i in range(len(names))}, big["values"]))
        evid = os.path.join(tmp, "big.evid")
        with open(evid, "w") as f:
            f.write(" ".join([str(len(ev))] + [f"{k} {v}" for k, v in ev.items()]))
        factors, sizes, values = load_uai(model)
        tree = jt.create_junction_tree(factors, sizes)
        ref = tree.engine(device=dev, dtype=torch.float64).set_potentials(values)
        post, logz = ref.posterior_batch(jt.batch_masks_sparse(tree.plan, [ev]))
        want_mar = np.concatenate(
            [post[tree.plan.table.id_of(v)][0].cpu().numpy() for v in range(len(names))])
        want_pr = float(logz[0]) / np.log(10.0)
        for task in ("MAR", "PR"):
            k1 = K1Counts()
            calls0 = route_calls()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([model, "--evidence", evid, "--task", task,
                               "--device", "cuda"])
            secs = time.perf_counter() - t0
            require(rc == 0, f"CLI {task} exited {rc}")
            routed = route_calls() - calls0
            require(routed > 0 and k1.launches == routed,
                    f"CLI {task}: {routed} routed calls, {k1.launches} "
                    "kernel launches")
            out = buf.getvalue().split()
            require(out[0] == task, f"CLI {task} printed {out[:2]}")
            if task == "MAR":
                toks = [float(t) for t in out[1:]]
                got, i = [], 1
                for _ in range(int(toks[0])):
                    n = int(toks[i])
                    got.extend(toks[i + 1:i + 1 + n])
                    i += 1 + n
                err = float(np.abs(np.array(got) - want_mar).max())
                require(err <= 1e-5, f"CLI MAR differs from float64 by {err}")
            else:
                err = abs(float(out[1]) - want_pr)
                require(err <= 1e-5, f"CLI PR differs from float64 by {err}")
            line.update({f"{task}_seconds": secs, f"{task}_routed_calls": routed,
                         f"{task}_kernel_launches": k1.launches,
                         f"{task}_max_abs_err_vs_f64": err})
    emit(line)


def peak_rise(fn):
    """(result of ``fn()``, peak bytes allocated during it above what was
    allocated just before)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    out, peak = peak_bytes(fn)
    return out, peak - base


def phase_memory(dev, hail, big):
    """The memory estimates against measured peaks under the default 8 GiB
    budget: ``max_feasible_batch`` for hailfinder_like's ``posterior_batch``
    and tree-MAP (the call's peak rise plus the standing potentials, and
    what the card keeps beside them for the kernel, within the budget at
    the returned B, above it at 2B), the kept bytes of the big clique's
    engine after a call in float32 and bfloat16 within their bound, also
    over evidence on 1, 2 and 12 of its variables in turn (splits and kept
    bytes of each call), and the cutset engine's chunks at B = 1024 (peak
    rise within 1.25 x its budget)."""
    import numpy as np
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.ops import factored_contract as fc

    budget = 8 << 30
    tree, values, labels = hail["tree"], hail["values"], hail["labels"]
    plan = tree.plan
    line = {"phase": "memory_estimates", "model": "hailfinder_like",
            "budget_bytes": budget}
    seps = sum(int(np.prod([plan.sizes[v] for v in sv]))
               for sv in plan.tree.separators)
    engines = {"posterior": hail["eng"],
               "map": tree.engine("max_product", device=dev).set_potentials(values)}
    for task, eng in engines.items():
        kept = eng._kept_bytes_bound()
        held = 4 * plan.stats()["total_clique_states"] + kept
        B = eng.max_feasible_batch(budget, task=task)
        rises = []
        for b in (B, 2 * B):
            masks = jt.batch_masks_sparse(
                plan, jt.random_evidence_batch(plan, b, labels, seed=11))
            if task == "map":
                lm = log_masks(masks)
                _, rise = peak_rise(lambda: eng.map_assignment_batch(lm))
            else:
                _, rise = peak_rise(lambda: eng.posterior_batch(masks))
            rises.append(rise)
        require(rises[0] + held <= budget,
                f"{task}: {rises[0] + held} bytes at B = {B}, over the budget")
        require(rises[1] + held > budget,
                f"{task}: {rises[1] + held} bytes at 2B = {2 * B}, inside the "
                "budget: the estimate is not the largest power of two")
        # float32 tree-MAP on the card: the fused collect holds no [B,
        # clique] tensor; a row is its messages and backpointers, and the
        # 8-byte keys of the largest separator while it is collected
        st = plan.stats()
        reckoned = (4 * (eng.ROW_CLIQUES[task] * st["max_clique_states"]
                         + 2 * seps) if task == "posterior"
                    else 4 * 2 * seps + 8 * st["max_sep_states"])
        line.update({f"{task}_B": B, f"{task}_kept_bytes_bound": kept,
                     f"{task}_bytes_at_B": rises[0] + held,
                     f"{task}_bytes_at_2B": rises[1] + held,
                     f"{task}_measured_bytes_per_row": (rises[1] - rises[0]) / B,
                     f"{task}_reckoned_bytes_per_row": reckoned})
    del engines
    torch.cuda.empty_cache()
    # the big clique: what its engine keeps after one posterior_batch (its
    # 19 layouts), within what max_feasible_batch counts; then evidence on
    # 1 and 2 of its variables (bf16 rows of few columns pad most) and back,
    # twice: float32 splits and kept bytes of each call
    names = big["names"]
    few = [jt.batch_masks_sparse(big["tree"].plan, jt.random_evidence_batch(
        big["tree"].plan, 256, obs, seed=12)) for obs in (names[5:6], names[16:])]
    for dtype in (torch.float32, torch.bfloat16):
        eng = big["tree"].engine(device=dev, dtype=dtype).set_potentials(
            big["values"])
        before = torch.cuda.memory_allocated()
        eng.posterior_batch(big["masks"])
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        now, bound = eng.describe()["kept_layouts"], eng._kept_bytes_bound()
        require(0 < now["bytes"] <= bound and now["bytes"] <= grown,
                f"big clique {dtype}: kept {now}, bound {bound}, the call "
                f"left {grown} bytes allocated")
        key = "big_clique_" + str(dtype).split(".")[-1]
        line.update({key + "_kept_layouts": now["layouts"],
                     key + "_kept_bytes": now["bytes"],
                     key + "_kept_bytes_bound": bound,
                     key + "_left_allocated_by_first_call": grown,
                     key + "_max_feasible_batch": eng.max_feasible_batch(budget)})
        # bf16 rows of R1*C < 8 columns (evidence on 1 or 2 variables) are
        # too short for the Tensor Memory Accelerator: each is copied into
        # padded rows when its layout is made (up to 8x the potential's
        # bytes, which the bound counts); those copies are counted here,
        # apart from phase tma_copies, which holds the serving phases'
        # evidence patterns to none
        calls, n = [], K1Counts()
        for m in few + [big["masks"]] + few + [big["masks"]]:
            made = kept_counts(lambda: eng.posterior_batch(m))
            kept_now = eng.describe()["kept_layouts"]
            require(kept_now["layouts"] <= 19 and kept_now["bytes"] <= bound,
                    f"big clique {dtype}: kept {kept_now}, bound {bound}")
            calls.append([made["splits"], made["kept_made"], kept_now["bytes"]])
        line[key + "_patterns_1_2_12_var_splits_made_kept_bytes"] = calls
        line[key + "_patterns_padded_operands"] = n.padded
        take_back("factored_masked_contract.padded", n.padded)
        del eng
    torch.cuda.empty_cache()
    # the cutset engine at B = 1024 under its default 8 GiB chunk budget
    hf, hs, hv = hail["factors"], hail["sizes"], hail["values"]
    hnames = list(hs)
    Bc = 1024
    rng = np.random.default_rng(0)
    cmasks = {}
    for v in hnames[::5]:
        m = np.zeros((Bc, hs[v]), dtype=np.float32)
        m[np.arange(Bc), rng.integers(0, hs[v], Bc)] = 1.0
        cmasks[v] = m
    ce = jt.CutsetEngine(hf, hs, hv, target_states=1 << 14, max_enum=512,
                         device=dev)
    st = ce.describe()
    chunk = ce._chunk_for(Bc)
    _, crise = peak_rise(lambda: ce.posterior_batch(cmasks))
    require(crise <= 1.25 * ce._chunk_budget,
            f"cutset: peak rise {crise} over 1.25 x the budget {ce._chunk_budget}")
    line.update(cutset_B=Bc, cutset_states=st["cutset_states"],
                cutset_chunk=chunk, cutset_chunk_budget_bytes=ce._chunk_budget,
                cutset_reckoned_bytes_per_chunk=4 * Bc * st["total_clique_states"]
                * 2 * chunk,
                cutset_peak_rise_bytes=crise,
                cutset_peak_rise_over_budget=crise / ce._chunk_budget)
    del ce
    torch.cuda.empty_cache()
    emit(line)



# the parallel phase's sizes: the configurations of the earlier phases
PARALLEL = dict(big_B=4096, tp_min_states=1 << 17, grid_B=4096,
                map_chunk=1024, chain_n=5000, chain_B=1024, loopy_B=256)


def _tp_contract_times(dev, mesh, shapes, device_ms):
    """The sharded contraction as ``Engine.shard_model`` runs it (R1 blocks
    cut in the kernel's layout, one kernel launch per model shard, the
    partials summed) at each (R1, R2, C, B) of ``shapes``, against the
    plain version and one ``einsum`` on the whole inputs: {shape: times}."""
    import numpy as np
    import torch

    from junctiontree_tpu_torch.ops import factored_contract as fc
    from junctiontree_tpu_torch.parallel.tp import (
        ShardedPotential,
        sharded_factored_contract,
        tp_contract_fn,
    )

    rng = np.random.default_rng(3)
    contract = tp_contract_fn(mesh)
    out = {}
    for R1, R2, C, B in sorted(set(shapes)):
        host = rng.random((R1, R2, C), dtype=np.float32)
        blocks = ShardedPotential(host, mesh, torch.float32, torch.float32,
                                  dev).kernel_layout([0], [1], [2],
                                                     fc.tiles_by_n(C))
        pot = torch.as_tensor(host, device=dev)
        w1 = torch.rand((B, R1), device=dev)
        w2 = torch.rand((B, R2), device=dev)
        got = contract(blocks, w1, w2)
        want = fc.reference_factored_contract(pot, w1, w2)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        require(err / want.abs().max().item() <= 1e-5,
                f"sharded contraction disagrees at {(R1, R2, C, B)}: {err}")
        def as_handed(x):   # the layout the route hands the kernel
            if fc.tiles_by_n(C):
                return x.permute(1, 0, 2).contiguous().permute(1, 0, 2)
            return x.contiguous()

        shard, whole = as_handed(pot[:R1 // 4]), as_handed(pot)
        bound, by = kernel_bound_ms(R1, R2, C, B, False)
        out[R1, R2, C, B] = dict(
            ms=device_ms(lambda: contract(blocks, w1, w2)),
            sharded_factored_contract_ms=device_ms(
                lambda: sharded_factored_contract(mesh, pot, w1, w2,
                                                  shard_batch=False)),
            one_shard_launch_ms=device_ms(
                lambda: fc.factored_masked_contract(shard, w1[:, :R1 // 4], w2)),
            # the library on the same shard's own operands
            one_shard_library_ms=device_ms(
                lambda: torch.einsum("rsc,br,bs->bc", shard, w1[:, :R1 // 4],
                                     w2)),
            one_shard_library_factored_contract_ms=device_ms(
                lambda: fc.library_factored_contract(shard, w1[:, :R1 // 4],
                                                     w2)),
            unsharded_launch_ms=device_ms(
                lambda: fc.factored_masked_contract(whole, w1, w2)),
            plain_ms=device_ms(lambda: fc.reference_factored_contract(pot, w1, w2)),
            library_ms=device_ms(lambda: torch.einsum("rsc,br,bs->bc", pot, w1, w2)),
            bound_ms=bound, bound_by=by, max_abs_err=err)
    return out


def _forest_model():
    """Three components of different shapes and a scalar factor
    (``tests/test_parallel_tp_forest.py``'s forest)."""
    import numpy as np

    from junctiontree_tpu_torch.models import grid_mrf_model

    f1, s1, v1 = grid_mrf_model(2, 2, seed=1)
    factors = list(f1) + [["h", "i"], ["i"]] + [["z"]] + [[]]
    sizes = dict(s1, h=3, i=2, z=4)
    rng = np.random.default_rng(0)
    values = list(v1) + [rng.random((3, 2)) + 0.1, rng.random(2) + 0.1,
                         rng.random(4) + 0.1, np.array(2.0)]
    return factors, sizes, values


def _mp_masks():
    """The 3x3 grid, B = 8, evidence on its first three variables."""
    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.models import grid_mrf_model

    factors, sizes, values = grid_mrf_model(3, 3, seed=0)
    plan = jt.compile_plan(factors, sizes)
    evs = jt.random_evidence_batch(plan, 8, list(sizes)[:3], seed=1)
    return plan, values, jt.batch_masks(plan, evs)


def mp_worker(pid: int, nproc: int, port: int, device: str) -> int:
    """One of the two processes of the ``parallel`` phase: joins the group
    through ``multihost.initialize`` (gloo: NCCL refuses two ranks on one
    GPU), serves its half of the rows on ``device`` through
    ``make_sharded_query_shardmap`` and prints the global mean logZ."""
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.parallel import multihost
    from junctiontree_tpu_torch.parallel.batch import make_sharded_query_shardmap

    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=nproc, process_id=pid, backend="gloo")
    try:
        dev = torch.device(device)
        plan, values, full = _mp_masks()
        eng = jt.Engine(plan, device=dev).set_potentials(values)
        mesh = multihost.make_multihost_mesh(devices=[dev])
        per = len(full[0]) // nproc
        local = multihost.host_local_batch_to_global(
            mesh, [m[pid * per:(pid + 1) * per] for m in full])
        _, z, mean = make_sharded_query_shardmap(plan, mesh)(eng._pots,
                                                             local.arrays)
        print(json.dumps({"pid": pid, "gsum": float(mean), "rows": int(z.shape[0]),
                          "offset": local.offset, "total": local.total,
                          "backend": torch.distributed.get_backend()}),
              flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_parallel(dev, main_shapes, profile, device_ms):
    """The parallel surface on one card, its meshes repeating cuda:0:
    (a) ``shard_model`` of the big clique over 4 model shards, and over
    (2, 2) with the rows split too; (b) ``shard_batch`` of the 8x8 grid over
    2 devices with ``posterior_batch`` and ``map_assignment_batch(chunk=)``;
    (c) ``shard_sequence`` of the 5,000-chain over 4 devices against the
    sequential program; (d) the forest engine against the monolithic one;
    (e) two processes over ``torch.distributed``; (f) loopy BP over a mesh.
    Returns the kernel-table entry of the sharded contraction."""
    import os
    import socket

    import numpy as np
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.models import chain_bn_model, grid_mrf_model
    from junctiontree_tpu_torch.parallel import make_mesh
    from junctiontree_tpu_torch.parallel.forest import ForestEngine

    t_phase = time.perf_counter()
    line = {"phase": "parallel", "mesh_devices": str(dev)}

    # (a) tensor parallelism: the big clique, B = 4096, float32
    factors, sizes, values, names = big_clique_model()
    plan = jt.compile_plan(factors, sizes)
    masks = jt.batch_masks_sparse(plan, jt.random_evidence_batch(
        plan, PARALLEL["big_B"], names[:12], seed=1))
    masks[names[0]][0] = 0.0  # row 0: impossible evidence
    eng0 = jt.Engine(plan, device=dev).set_potentials(values)
    post0, logz0 = eng0.posterior_batch(masks)
    rows = 64
    ref = jt.Engine(plan, device=dev, dtype=torch.float64).set_potentials(values)
    ref_post, ref_logz = ref.posterior_batch({k: v[:rows] for k, v in masks.items()})
    del ref
    mesh4 = make_mesh(1, 4, devices=[dev] * 4)
    tp = {}
    for label, mesh, shard_batch in (("1x4", mesh4, False),
                                     ("2x2", make_mesh(2, 2, devices=[dev] * 4), True)):
        eng = jt.Engine(plan, device=dev).shard_model(
            mesh, min_states=PARALLEL["tp_min_states"],
            shard_batch=shard_batch).set_potentials(values)
        k1 = K1Counts()
        post, logz = eng.posterior_batch(masks)
        torch.cuda.synchronize()
        launches = k1.launches
        require(launches == 4 * len(main_shapes),
                f"TP {label}: {launches} kernel launches, expected "
                f"{4 * len(main_shapes)}")
        require(eng.describe()["tp_fallbacks"] == [],
                f"TP {label}: {eng.describe()['tp_fallbacks']}")
        err_f32 = check_close(post, logz, post0, logz0, len(post),
                              f"TP {label} vs unsharded", **F64_LIMITS)
        err_f64 = check_close(post, logz, ref_post, ref_logz, len(post),
                              f"TP {label} vs float64", rows=rows, **F64_LIMITS)
        tp[label] = dict(kernel_launches=launches,
                         steady_call=kept_counts(
                             lambda: eng.posterior_batch(masks)),
                         max_abs_err_vs_unsharded=err_f32,
                         max_abs_err_vs_f64=err_f64,
                         step_ms=step_ms(lambda: eng.posterior_batch(masks), iters=5))
        if profile and label == "1x4":
            busy, n_kernels, top = profile_step(lambda: eng.posterior_batch(masks))
            tp[label].update(device_busy_ms_per_step=busy,
                             kernels_per_step=n_kernels, top_kernels=top[:4])
        if label == "1x4":
            tp_launches = launches
        del eng, post
    tp["unsharded_step_ms"] = step_ms(lambda: eng0.posterior_batch(masks), iters=5)
    times = _tp_contract_times(dev, mesh4, main_shapes, device_ms)
    tp["contraction"] = {str(k): v for k, v in times.items()}
    line["tensor_parallel"] = tp
    del eng0, post0, ref_post
    torch.cuda.empty_cache()

    # (b) data parallelism: the 8x8 grid, B = 4096, over 2 devices
    factors, sizes, values = grid_mrf_model(8, 8, seed=0)
    plan = jt.compile_plan(factors, sizes)
    Bg = PARALLEL["grid_B"]
    gmasks = jt.batch_masks_sparse(
        plan, jt.random_evidence_batch(plan, Bg, list(sizes)[:20], seed=1))
    gmasks[list(sizes)[0]][7] = 0.0
    g0 = jt.Engine(plan, device=dev).set_potentials(values)
    g2 = jt.Engine(plan, device=dev).set_potentials(values).shard_batch(
        make_mesh(2, devices=[dev] * 2))
    p0, l0 = g0.posterior_batch(gmasks)
    p2, l2 = g2.posterior_batch(gmasks)
    dp_err = check_close(p2, l2, p0, l0, 64, "shard_batch vs unsharded",
                         rtol=1e-5, atol=1e-6, logz_atol=1e-4)
    logm = {k: np.where(v > 0, 0.0, -np.inf).astype(np.float32)
            for k, v in gmasks.items()}
    a0, s0 = g0.map_assignment_batch(logm)
    a2, s2 = g2.map_assignment_batch(logm, chunk=PARALLEL["map_chunk"])
    fin = s0 > -1e29
    require(torch.equal(fin, s2 > -1e29), "shard_batch MAP: infeasible rows")
    map_err = (s2[fin] - s0[fin]).abs().max().item()
    require(map_err <= 1e-3, f"shard_batch MAP scores differ by {map_err}")
    line["data_parallel"] = dict(
        model="8x8 grid", B=Bg, devices=2, max_abs_err_vs_unsharded=dp_err,
        map_chunk=PARALLEL["map_chunk"], map_max_score_err=map_err,
        map_assignments_equal=bool(torch.equal(a0, a2)),
        step_ms=step_ms(lambda: g2.posterior_batch(gmasks), iters=5),
        unsharded_step_ms=step_ms(lambda: g0.posterior_batch(gmasks), iters=5))
    del g0, g2, p0, p2
    torch.cuda.empty_cache()

    # (c) sequence parallelism: the 5,000-chain, B = 1024, over 4 devices
    n, B = PARALLEL["chain_n"], PARALLEL["chain_B"]
    factors, sizes, values = chain_bn_model(n, seed=1)
    plan = jt.compile_plan(factors, sizes)
    labels = [f"x{i}" for i in range(0, n, n // 10)]
    cmasks = jt.batch_masks_sparse(
        plan, jt.random_evidence_batch(plan, B, labels, seed=2))
    cmasks[labels[3]][2] = 0.0
    seq = jt.Engine(plan, device=dev).set_potentials(values)
    par = jt.Engine(plan, device=dev).set_potentials(values).shard_sequence(
        make_mesh(4, devices=[dev] * 4), min_len=2048)
    sp, sl = seq.posterior_batch(cmasks)
    pp, pl = par.posterior_batch(cmasks)
    require(("chain_parallel",) in par._programs and len(par._chain_A) == 4,
            "shard_sequence did not take the log-depth program")
    crow = 16
    cref = jt.Engine(plan, device=dev, dtype=torch.float64).set_potentials(values)
    rp, rl = cref.posterior_batch({k: v[:crow] for k, v in cmasks.items()})
    del cref
    sp_err = check_close(pp, pl, sp, sl, n, "log-depth vs sequential chain",
                         rtol=1e-4, atol=1e-4, logz_atol=1e-2)
    sp_f64 = check_close(pp, pl, rp, rl, n, "log-depth chain vs float64",
                         rtol=1e-4, atol=1e-4, logz_atol=1e-2, rows=crow)
    seq_line = dict(
        variables=n, B=B, devices=4, max_abs_err_vs_sequential=sp_err,
        max_abs_err_vs_f64=sp_f64, limits={"atol": 1e-4, "logz_atol": 1e-2},
        parallel_step_ms=step_ms(lambda: par.posterior_batch(cmasks), iters=3),
        sequential_step_ms=step_ms(lambda: seq.posterior_batch(cmasks), iters=3))
    if profile:
        for name, e in (("parallel", par), ("sequential", seq)):
            busy, n_kernels, top = profile_step(
                lambda: e.posterior_batch(cmasks), steps=2)
            seq_line[name + "_device_busy_ms_per_step"] = busy
            seq_line[name + "_launches_per_step"] = n_kernels
            seq_line[name + "_top_kernels"] = top[:3]
    line["sequence_parallel"] = seq_line
    del seq, par, sp, pp, rp
    torch.cuda.empty_cache()

    # (d) the forest engine against the monolithic engine
    factors, sizes, values = _forest_model()
    evs = [{"g0_0": 1, "i": 0}, {"z": 2}, {}, {"h": 2, "g1_1": 0}]
    fpost, flogz = ForestEngine(factors, sizes, devices=[dev, dev]) \
        .set_potentials(values).posterior_batch(evs)
    plan = jt.compile_plan(factors, sizes)
    mpost, mlogz = jt.Engine(plan, device=dev).set_potentials(values) \
        .posterior_batch(jt.batch_masks_sparse(plan, evs))
    forest_err = max((fpost[v] - mpost[plan.table.id_of(v)]).abs().max().item()
                     for v in sizes)
    lz = (flogz - mlogz).abs().max().item()
    require(forest_err <= 1e-5 and lz <= 1e-5,
            f"forest differs from the monolithic engine: {forest_err}, {lz}")
    line["forest"] = dict(components=3, B=len(evs), max_abs_err=forest_err,
                          max_logz_err=lz)

    # (e) two processes on cuda:0 through torch.distributed
    plan, values, full = _mp_masks()
    _, z = jt.Engine(plan, device=dev).set_potentials(values).query_batch(full)
    want = float(torch.log(z.double()).mean())
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mp-worker", str(pid),
         "2", str(port), str(dev)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            require(p.returncode == 0, f"worker failed: {out}\n{err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    gsums = [o["gsum"] for o in outs]
    require(gsums[0] == gsums[1], f"the processes disagree: {gsums}")
    require(abs(gsums[0] - want) <= 1e-5 * abs(want),
            f"global mean logZ {gsums[0]} against one process's {want}")
    line["two_processes"] = dict(
        backend=outs[0]["backend"],
        why_gloo="NCCL refuses two ranks on one GPU",
        global_mean_logz=gsums, one_process_mean_logz=want,
        rows=[o["rows"] for o in outs], offsets=[o["offset"] for o in outs],
        seconds=time.perf_counter() - t0)

    # (f) loopy BP with the evidence batch over a mesh
    factors, sizes, values = grid_mrf_model(8, 8, seed=0)
    rng = np.random.default_rng(1)
    lmasks = {}
    Bl = PARALLEL["loopy_B"]
    for v in list(sizes)[:20]:
        m = np.zeros((Bl, 2), dtype=np.float32)
        m[np.arange(Bl), rng.integers(0, 2, Bl)] = 1.0
        lmasks[v] = m
    one = jt.LoopyEngine(factors, sizes, values, device=dev, tol=1e-5)
    split = jt.LoopyEngine(factors, sizes, values, tol=1e-5,
                           mesh=make_mesh(4, devices=[dev] * 4))
    q1, z1, i1 = one.posterior_batch(lmasks)
    q2, z2, i2 = split.posterior_batch(lmasks)
    require(i1["iters"] == i2["iters"], "loopy BP: iterations differ on a mesh")
    loopy_err = max((q1[v] - q2[v]).abs().max().item() for v in range(64))
    loopy_lz = (z1 - z2).abs().max().item()
    require(loopy_err <= 1e-5 and loopy_lz <= 1e-4,
            f"loopy BP on a mesh differs: {loopy_err}, {loopy_lz}")
    line["loopy"] = dict(grid="8x8", B=Bl, devices=4, iters=i2["iters"],
                         max_abs_err_vs_one_device=loopy_err,
                         max_logz_err=loopy_lz)
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bound_ops_ms=0.0, max_abs_err=0.0)
    for sh in main_shapes:
        t = times[sh]
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[k] += t[k]
        tot["bound_ops_ms"] += t["bound_ms"] * (t["bound_by"] == "operations")
        tot["max_abs_err"] = max(tot["max_abs_err"], t["max_abs_err"])
    return tp_launches, tot


def main() -> int:
    import shutil
    import tempfile

    if sys.argv[1:2] == ["--mp-worker"]:
        return mp_worker(*(int(a) for a in sys.argv[2:5]), sys.argv[5])

    from junctiontree_tpu_torch.config import DEFAULT

    # the measured decisions live in a directory of this run's own
    DEFAULT.autotune_cache_dir = tempfile.mkdtemp(prefix="jtt_autotune_")
    try:
        return run()
    finally:
        shutil.rmtree(DEFAULT.autotune_cache_dir, ignore_errors=True)


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on the GPU only", file=sys.stderr)
        return 2
    import numpy as np

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.models import sprinkler_model
    from junctiontree_tpu_torch.ops import cuda_build
    from junctiontree_tpu_torch.ops import factored_contract as fc
    from junctiontree_tpu_torch.utils.bench_kernel import device_ms, host_us

    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # -- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load_library()
    regs = [ln.strip() for ln in cuda_build.build_log().splitlines()
            if "registers" in ln or "spill" in ln]
    require(len(regs) > 0, "no ptxas report in the build log")
    require(all("0 bytes spill stores, 0 bytes spill loads" in ln
                for ln in regs if "spill" in ln),
            f"ptxas reports register spills: {regs}")
    sass = cuda_build.sass_op_counts()
    mma = cuda_build.tensor_core_op_counts()
    # the tensor-core kernels (bf16, and float32 at "highest" and "default",
    # three epilogues each) run wgmma (HGMMA) fed by the Tensor Memory
    # Accelerator (UTMALDG); the narrow float32 kernel (N <= 32), the pot
    # split, the tree-MAP collect and the chain program's row pass run no
    # tensor-core operation; no other kernel is left (the
    # contraction kernels add their own r2 partials)
    tc_kinds = {src + epi for src in ("bf16", "f32", "f32_default")
                for epi in ("_by_c", "_fold", "_smem")} | {"f32_fold_pairs"}
    require(tc_kinds | {"f32_narrow", "split", "map_collect",
                        "chain_step"} == set(sass),
            f"unexpected kernels in the library: {sorted(sass)}")
    require(all(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0
                for k, ops in sass.items() if k in tc_kinds),
            f"a tensor-core kernel without HGMMA or UTMALDG: {sass}")
    require(all(n == 0 for k, n in mma.items() if k not in tc_kinds),
            f"tensor-core operations outside the tensor-core kernels: {mma}")
    # clusters of 1..8 blocks the card holds at once: what sets the split
    # of r2 (launch_config)
    slots = {f"{src}, bn={bn}, by_n={by_n}":
             list(fc._cluster_slots(dev, src, bn, by_n))
             for src in ("bf16", "f32x6")
             for bn, by_n in ((64, False), (64, True), (128, True))}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(cuda_build.build_seconds, 3),
          "library": cuda_build.library_path(), "ptxas": regs[:16],
          "tensor_core_op_counts": mma, "sass_op_counts": sass,
          "cluster_slots": slots})

    # -- 3. kernel against the plain version ---------------------------------
    factors, sizes, values, names = big_clique_model()
    tree = jt.create_junction_tree(factors, sizes)
    plan = tree.plan
    B = 4096
    evs = jt.random_evidence_batch(plan, B, names[:12], seed=1)
    masks = jt.batch_masks_sparse(plan, evs)
    masks[names[0]][0] = 0.0  # row 0: impossible evidence
    # what each path of the big clique asks of the kernel (CPU meta tensors)
    paths = {
        "posterior_batch": lambda e: e.posterior_batch(masks),
        "entropy_batch": lambda e: e.entropy_batch(masks),
        "joint_marginal_batch over 2": lambda e: e.joint_marginal_batch(
            names[12:14], masks),
        "joint_marginal_batch over 3": lambda e: e.joint_marginal_batch(
            names[15:18], masks),
    }
    path_shapes = {k: k1_calls_on_meta(plan, values, run)
                   for k, run in paths.items()}
    tailed = tailed_session()
    path_shapes[TAILED_PATH] = tailed["both"]
    # the learning paths: forward and backward calls of one E-step, with
    # the strides of the potential as the route or the backward pass hands
    # it to the wrapper
    learn_models = learning_models()
    path_shapes[LEARN_BIG] = [c[0] for c in learn_models["big"]["calls"]]
    path_shapes[LEARN_FWD] = [
        c[0] for c in learn_models["tailed"]["calls"] if not c[2]]
    path_shapes[LEARN_BWD] = [
        c[0] for c in learn_models["tailed"]["calls"] if c[2]]
    handed = {c[0][:3]: c[1] for lm in learn_models.values() for c in lm["calls"]}
    require(all(len(v) > 0 for v in path_shapes.values()),
            f"a big-clique path routes no kernel call: {path_shapes}")
    main_shapes = path_shapes["posterior_batch"]
    # per shape: {path: calls of one step}
    per_call = {}
    for k, shapes in path_shapes.items():
        for sh in shapes:
            per_call.setdefault(sh, {})[k] = shapes.count(sh)
    # edges: R1 = 1, ragged, C = 300 (r1 looped in the block), B = 70,000,
    # rows that are not 16-byte aligned in w2, in pot, in both tilings; then
    # joints over 5 and 6 query variables (C = 32 and 64: either side of the
    # choice between the two column tilings), and R1 = 1 and unaligned rows
    # at the joints' C
    edge_shapes = [(1, 37, 1, 5), (3, 50, 17, 33), (5, 70, 300, 130),
                   (64, 4095, 1, 4097), (2, 40, 3, 70000), (4, 37, 3, 130),
                   (3, 64, 3, 40), (2, 64, 50, 100),
                   (64, 128, 32, 4096), (64, 64, 64, 4096), (1, 512, 8, 4096),
                   (1, 37, 4, 130), (3, 37, 8, 130), (1, 50, 64, 100),
                   (3, 37, 33, 130)]
    g = torch.Generator(device=dev).manual_seed(0)

    def rand_pot(R1, R2, C, dtype, as_handed=True):
        """pot [R1, R2, C]; as_handed: in the memory layout that
        big_clique_sep_message hands the kernel (no copy in the wrapper)."""
        if as_handed and (R1, R2, C) in handed:
            return torch.rand((R1 * R2 * C,), generator=g, device=dev).to(
                dtype).as_strided((R1, R2, C), handed[R1, R2, C])
        if as_handed and fc.tiles_by_n(C):
            return torch.rand((R2, R1, C), generator=g,
                              device=dev).to(dtype).permute(1, 0, 2)
        return torch.rand((R1, R2, C), generator=g, device=dev).to(dtype)

    # per dtype and path, summed over the launches of one call of the path
    totals = {(bf16, k): dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                              bound_ms=0.0, bound_ops_ms=0.0, max_abs_err=0.0)
              for bf16 in (False, True) for k in path_shapes}
    # the float32 split of the engine's potential, one per routed call of
    # an engine's first posterior_batch (kept after it)
    split_tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for shape in list(per_call) + edge_shapes:
        R1, R2, C, Bk = shape
        serving = shape in per_call
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            # an edge shape also takes the wrapper's one-copy path
            pot = rand_pot(R1, R2, C, dtype, as_handed=serving)
            # w1 in float32 on the serving paths, as the route hands it
            # (bf16 storage rounds only pot and w2); the einsum below takes
            # one dtype, so it gets its own copy
            w1 = torch.rand((Bk, R1), generator=g, device=dev)
            w1 = w1 if serving else w1.to(dtype)
            w1_lib = w1.to(dtype)
            w2 = torch.rand((Bk, R2), generator=g, device=dev).to(dtype)
            got = fc.factored_masked_contract(pot, w1, w2)
            want = fc.reference_factored_contract(pot, w1, w2)
            torch.cuda.synchronize()
            abs_err = (got - want).abs().max().item()
            rel = abs_err / want.abs().max().item()
            # bf16 inputs: f32 sums of exact products, within 2e-6 on the
            # serving path and 2e-2 (bf16's own rounding of f32 inputs)
            # elsewhere; float32 (six bf16 passes, or the narrow FMA
            # kernel) within 2e-6 on the serving paths, 1e-5 elsewhere
            tol = 2e-6 if serving else (2e-2 if bf16 else 1e-5)
            require(rel <= tol, f"kernel disagrees at {shape} {dtype}: {rel}")
            line = {"phase": "kernel_vs_plain", "R1": R1, "R2": R2, "C": C,
                    "B": Bk, "dtype": str(dtype).split(".")[-1],
                    "max_abs_err": abs_err, "rel_err": rel, "tol": tol,
                    "on_serving_path": serving}
            if serving:
                again = fc.factored_masked_contract(pot, w1, w2)
                require(torch.equal(got, again), f"two runs differ at {shape}")
                line.update(split_line(pot, w1, w2))
                line.update(in_kernel_sum(pot, w1, w2, got))
                n_main = per_call[shape].get("posterior_batch", 0)
                if "split_ms" in line and n_main:
                    for key in split_tot:
                        split_tot[key] += line["split_" + key] * n_main
                # the operand kept as for a standing potential: what a
                # serving call reads after its engine's first
                fc.standing(pot, 1)
                lay = fc.StandingLayout(pot, [0], [1], [2], fc.tiles_by_n(C))
                require(torch.equal(fc.factored_masked_contract(lay, w1, w2),
                                    got), f"kept operand differs at {shape}")
                kept = device_ms(lambda: fc.factored_masked_contract(
                    lay, w1, w2))
                line.update(kept_ms=kept, kept_host_us_per_call=host_us(
                    lambda: fc.factored_masked_contract(lay, w1, w2)))
                k = device_ms(lambda: fc.factored_masked_contract(pot, w1, w2))
                p = device_ms(lambda: fc.reference_factored_contract(pot, w1, w2))
                # the one PyTorch call for the same function (TF32 is off);
                # a yardstick only: the package never calls it
                lib = device_ms(
                    lambda: torch.einsum("rsc,br,bs->bc", pot, w1_lib, w2))
                bound, by = kernel_bound_ms(R1, R2, C, Bk, bf16)
                line.update(
                    library_factored_contract_ms=device_ms(
                        lambda: fc.library_factored_contract(pot, w1, w2)),
                    ms=k, plain_ms=p, library_ms=lib, bound_ms=bound,
                    bound_by=by, share_of_bound=bound / k,
                    host_us_per_call=host_us(
                        lambda: fc.factored_masked_contract(pot, w1, w2)),
                    calls_per_step=per_call[shape])
                for path, n in per_call[shape].items():
                    tot = totals[bf16, path]
                    # serving paths read the kept operand; the learning
                    # paths' potentials need a gradient: split every call
                    tot["ms"] += (k if path in LEARN_PATHS else kept) * n
                    tot["plain_ms"] += p * n
                    tot["library_ms"] += lib * n
                    tot["bound_ms"] += bound * n
                    tot["bound_ops_ms"] += bound * n * (by == "operations")
                    tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
            emit(line)

    # one model shard of each serving shape (Engine.shard_model over 4 model
    # shards: R1 / 4), timed as single launches beside the library on the
    # shard's own operands, in the layout the tensor-parallel route hands
    # the kernel
    for R1, R2, C, Bk in sorted({(R1 // 4, R2, C, Bk)
                                 for R1, R2, C, Bk in main_shapes}):
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            pot = rand_pot(R1, R2, C, dtype)
            w1 = torch.rand((Bk, R1), generator=g, device=dev)
            w1_lib = w1.to(dtype)
            w2 = torch.rand((Bk, R2), generator=g, device=dev).to(dtype)
            got = fc.factored_masked_contract(pot, w1, w2)
            want = fc.reference_factored_contract(pot, w1, w2)
            torch.cuda.synchronize()
            abs_err = (got - want).abs().max().item()
            rel = abs_err / want.abs().max().item()
            tol = 2e-6
            require(rel <= tol, f"kernel disagrees at shard {R1, R2, C, Bk} "
                                f"{dtype}: {rel}")
            require(torch.equal(got, fc.factored_masked_contract(pot, w1, w2)),
                    f"two runs differ at shard {R1, R2, C, Bk} {dtype}")
            cfg = fc.launch_config(Bk, R1, R2, C, torch.cuda.get_device_properties(
                dev).multi_processor_count, bf16)
            sums = in_kernel_sum(pot, w1, w2, got)
            k = device_ms(lambda: fc.factored_masked_contract(pot, w1, w2))
            bound, by = kernel_bound_ms(R1, R2, C, Bk, bf16)
            emit({"phase": "kernel_vs_plain", "shard_of": [R1 * 4, R2, C, Bk],
                  "R1": R1, "R2": R2, "C": C, "B": Bk,
                  "dtype": str(dtype).split(".")[-1], "max_abs_err": abs_err,
                  "rel_err": rel, "tol": tol, "route": cfg["src"],
                  "column_tile": cfg["bn"], "row_tile": cfg["bm"], "ms": k,
                  "plain_ms": device_ms(
                      lambda: fc.reference_factored_contract(pot, w1, w2)),
                  "library_ms": device_ms(
                      lambda: torch.einsum("rsc,br,bs->bc", pot, w1_lib, w2)),
                  "library_factored_contract_ms": device_ms(
                      lambda: fc.library_factored_contract(pot, w1, w2)),
                  "bound_ms": bound, "bound_by": by,
                  "share_of_bound": bound / k, **sums})

    # the serving floor 1e-38 is subnormal in f32 and bf16: it must not be
    # flushed, and exact zeros must stay exact zeros
    for dtype in (torch.float32, torch.bfloat16):
        R1, R2, C, Bk = main_shapes[0]
        pot = (rand_pot(R1, R2, C, torch.float32) + 0.5).to(dtype)
        w1 = torch.ones((Bk, R1), device=dev, dtype=dtype)
        w2 = torch.rand((Bk, R2), generator=g, device=dev).to(dtype)
        w2[0], w2[1], w1[2] = 1e-38, 0.0, 0.0
        got = fc.factored_masked_contract(pot, w1, w2)
        want = fc.reference_factored_contract(pot, w1, w2)
        torch.cuda.synchronize()
        require(bool((want[0] > 0).all()), "plain version flushed 1e-38")
        worst = ((got[0] - want[0]).abs() / want[0]).max().item()
        require(worst <= 1e-3, f"{dtype}: subnormal inputs flushed ({worst})")
        require(bool((got[1] == 0).all()) and bool((got[2] == 0).all()),
                f"{dtype}: zero rows are not exactly zero")
        emit({"phase": "kernel_subnormals", "dtype": str(dtype).split(".")[-1],
              "row_of_1e-38_rel_err": worst, "row_sum": want[0, 0].item(),
              "zero_rows_exact": True})

    # every path from here on is a serving path: no operand may need a copy
    # into an aligned buffer before its tensor maps; the copies, if any, are
    # named in the failure
    serving_copies = K1Counts()
    copied = []
    tma_rows = fc._tma_rows

    def naming_copies(t):
        before = serving_copies.padded
        out = tma_rows(t)
        if serving_copies.padded > before and len(copied) < 8:
            copied.append((str(t.dtype), tuple(t.shape), tuple(t.stride()),
                           t.data_ptr() % 16))
        return out

    fc._tma_rows = naming_copies

    # -- 3b. the measurement, precision, the native compiler, the CLI, memory
    big = dict(tree=tree, factors=factors, values=values, masks=masks,
               names=names)
    phase_autotune(dev, tree, values, masks, main_shapes)
    hail = hailfinder_serving(dev)
    phase_precision(dev, hail)
    phase_native_compile()
    phase_cli(dev, big)
    phase_memory(dev, hail, big)
    torch.cuda.empty_cache()

    # -- 4. big-clique serving (the main path) -------------------------------
    eng = tree.engine(device=dev).set_potentials(values)
    k1 = K1Counts()
    (post, logz), peak_big = peak_bytes(lambda: eng.posterior_batch(masks))
    launches, splits = k1.launches, k1.splits
    require(k1.launches_bf16 == 0,
            "the float32 engine launched the bf16 kernel")
    require(splits == launches,
            f"{launches} float32 kernel launches but {splits} pot splits")
    require(launches == len(main_shapes),
            f"{launches} kernel launches, expected {len(main_shapes)}")
    # later calls read the splits kept beside the engine's potential
    steady = kept_counts(lambda: eng.posterior_batch(masks))
    require(steady["splits"] == 0 and steady["kept_hits"] == launches,
            f"a steady float32 posterior_batch: {steady}")
    # under torch.inference_mode(), the usual way to serve: the same bits
    with torch.inference_mode():
        inf_post, inf_logz = eng.posterior_batch(masks)
    require(torch.equal(inf_logz, logz) and all(
        torch.equal(a, b) for a, b in zip(inf_post, post)),
        "posterior_batch under inference mode differs")
    del inf_post, inf_logz
    kept_now = eng.describe()["kept_layouts"]
    rows = 64
    ref = tree.engine(device=dev, dtype=torch.float64).set_potentials(values)
    ref_post, ref_logz = ref.posterior_batch(
        {k: v[:rows] for k, v in masks.items()})
    worst = check_close(post, logz, ref_post, ref_logz, len(post),
                        "big clique vs float64", rows=rows, **F64_LIMITS)
    require(bool(torch.isneginf(logz[0])), "impossible row: logZ is not -inf")
    require(all(bool((p[0] == 0).all()) for p in post),
            "impossible row: posteriors are not zero")
    require(all(tuple(p.shape) == (B, 2) for p in post), "posterior shapes")
    t_big = step_ms(lambda: eng.posterior_batch(masks))
    if profile:
        busy, n_kernels, top = profile_step(lambda: eng.posterior_batch(masks))
        emit({"phase": "profile", "model": "big_clique", "step_ms": t_big,
              "device_busy_ms_per_step": busy,
              "kernels_per_step": n_kernels,
              "copy_kernels_per_step": profile_step.copies,
              "top_kernels": top})
    emit({"phase": "big_clique_serving", "B": B, "cliques": plan.tri.num_cliques,
          "max_clique_states": plan.stats()["max_clique_states"],
          "kernel_launches": launches, "pot_splits": splits,
          "steady_call": steady, "kept_layouts": kept_now,
          "kept_bytes_bound": eng._kept_bytes_bound(),
          "step_ms": t_big,
          "queries_per_s": B / t_big * 1e3, "peak_mem_bytes": peak_big,
          "max_abs_err_vs_f64": worst, "rows_checked": rows})
    del ref, ref_post

    # -- 4b. the same model with bfloat16 storage ---------------------------
    launches_bf16 = phase_bf16(dev, tree, values, masks, post, logz,
                               t_big, peak_big, len(main_shapes), profile)
    del eng, post

    # -- 5. classic-network serving (hailfinder_like, einsum route) ----------
    tree, factors, sizes, values = (hail[k] for k in
                                    ("tree", "factors", "sizes", "values"))
    plan, masks, eng, Bh, rows = (tree.plan, hail["masks"], hail["eng"],
                                  hail["B"], hail["rows"])
    k1 = K1Counts()
    (post, logz), peak = peak_bytes(lambda: eng.posterior_batch(masks))
    hail_launches = k1.launches
    worst_h = check_close(post, logz, hail["ref_post"], hail["ref_logz"],
                          len(post), "hailfinder_like vs float64", rows=rows,
                          **F64_LIMITS)
    require(bool(torch.isneginf(logz[1])), "impossible row: logZ is not -inf")
    require(all(bool((p[1] == 0).all()) for p in post),
            "impossible row: posteriors are not zero")
    t_hail = step_ms(lambda: eng.posterior_batch(masks), iters=3, warmup=1)
    if profile:
        busy, n_kernels, top = profile_step(
            lambda: eng.posterior_batch(masks), steps=2)
        emit({"phase": "profile", "model": "hailfinder_like", "step_ms": t_hail,
              "device_busy_ms_per_step": busy,
              "kernels_per_step": n_kernels, "top_kernels": top})
    # sprinkler on the card: P(rain | wet_grass) = 0.7079
    f, s, v = sprinkler_model()
    st = jt.create_junction_tree(f, s)
    seng = st.engine(device=dev).set_potentials(v)
    rain = st.plan.table.id_of("rain")
    sp, _ = seng.posterior_batch(jt.batch_masks_sparse(st.plan, [{"wet_grass": 1}]))
    sq, _ = seng.query({"wet_grass": 1})
    require(round(float(sp[rain][0, 1]), 4) == 0.7079, "sprinkler posterior_batch")
    require(round(float(sq[rain][1]), 4) == 0.7079, "sprinkler query")
    emit({"phase": "classic_serving", "model": "hailfinder_like", "B": Bh,
          "max_clique_states": plan.stats()["max_clique_states"],
          "max_sep_states": plan.stats()["max_sep_states"],
          "kernel_launches": hail_launches, "step_ms": t_hail,
          "queries_per_s": Bh / t_hail * 1e3, "peak_mem_bytes": peak,
          "max_abs_err_vs_f64": worst_h, "rows_checked": rows,
          "sprinkler_rain_given_wet": round(float(sp[rain][0, 1]), 4)})

    # -- 6. the rest of the serving path ------------------------------------
    phase_log(dev, tree, values, masks, post, logz)
    torch.cuda.empty_cache()
    hail.update(post=post, peak=peak)
    del hail["ref_post"], hail["ref_logz"]
    chain = phase_chain(dev, profile)
    chain_kernel = phase_chain_step_kernel(dev)
    grid = phase_fused(dev, profile)
    phase_chunked(dev, eng, plan, grid)

    # -- 7. the query surfaces beyond posteriors ------------------------------
    phase_map(dev, hail, chain, grid, profile)
    map_kernel = phase_map_kernel(dev, big)
    chain_model = chain[:2]
    del chain, grid, post
    hail["post"] = None
    torch.cuda.empty_cache()
    path_launches = phase_entropy_joint(dev, big, hail, path_shapes, profile)
    path_launches[TAILED_PATH] = phase_incremental(dev, hail, tailed)
    del tailed
    phase_surgery(dev, big, hail)
    del big

    # -- 8. learning and the solvers beside the engine -------------------------
    phase_kernel_backward(dev, device_ms, host_us)
    path_launches.update(phase_learning(dev, learn_models, chain_model, profile))
    del learn_models, chain_model
    torch.cuda.empty_cache()
    phase_solvers(dev, hail, profile)
    del eng, hail
    torch.cuda.empty_cache()

    # -- 9. the parallel surface (meshes of cuda:0) ----------------------------
    tp_launches, tp_tot = phase_parallel(dev, main_shapes, profile, device_ms)

    fc._tma_rows = tma_rows
    require(serving_copies.padded == 0,
            f"{serving_copies.padded} operands of the serving "
            "paths were copied into an aligned buffer (dtype, shape, strides, "
            f"address mod 16 of the first: {copied})")
    emit({"phase": "tma_copies", "padded_on_serving_paths": 0})

    # -- 10. kernel table, card, result -------------------------------------
    # the kernel once per dtype and path it serves; launches are those of
    # that path's serving phase, times are sums over one call of the path
    path_launches["posterior_batch"] = launches
    emit({"kernels": [{
        "name": "factored_masked_contract"
                + (" (bfloat16 inputs)" if bf16 else " (float32)"),
        "route": "cuda",
        "source": "junctiontree_tpu_torch/csrc/factored_contract.cu",
        "replaces": "junctiontree_tpu/ops/pallas_contract.py:286",
        "launches": n_launched, "max_abs_err": tot["max_abs_err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations"
                    if tot["bound_ops_ms"] * 2 > tot["bound_ms"] else "bytes",
        "library_ms": tot["library_ms"],
        "per": "%s (%d launches), %s" % (
            "a session opened and one delta, " + path if path == TAILED_PATH
            else "one " + path if path in (LEARN_BIG, LEARN_FWD, LEARN_BWD)
            else "one %s call on the big clique" % path,
            n_launched, "bfloat16 storage" if bf16 else "float32"),
    } for bf16, path, n_launched, tot in (
        [(False, k, path_launches[k], totals[False, k]) for k in path_shapes]
        + [(True, "posterior_batch", launches_bf16,
            totals[True, "posterior_batch"])])] + [{
        "name": "factored_masked_contract (float32, tensor-parallel)",
        "route": "cuda",
        "source": "junctiontree_tpu_torch/csrc/factored_contract.cu",
        "replaces": "junctiontree_tpu/ops/pallas_contract.py:286",
        "launches": tp_launches, "max_abs_err": tp_tot["max_abs_err"],
        "ms": tp_tot["ms"], "plain_ms": tp_tot["plain_ms"],
        "bound_ms": tp_tot["bound_ms"],
        "bound_by": "operations"
                    if tp_tot["bound_ops_ms"] * 2 > tp_tot["bound_ms"] else "bytes",
        "library_ms": tp_tot["library_ms"],
        "per": "one sharded big-clique posterior_batch, 4 model shards, "
               "float32 (%d launches)" % tp_launches,
    }, {
        "name": "split_pot_kernel (float32 pot into bf16 planes)",
        "route": "cuda",
        "source": "junctiontree_tpu_torch/csrc/factored_contract.cu",
        "replaces": "junctiontree_tpu/ops/pallas_contract.py:286",
        "launches": splits, "max_abs_err": 0.0,
        "ms": split_tot["ms"], "plain_ms": split_tot["plain_ms"],
        "bound_ms": split_tot["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "per": "an engine's first big-clique posterior_batch, float32 (%d "
               "launches; later calls read the kept planes)" % splits,
    }, map_kernel, chain_kernel]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
