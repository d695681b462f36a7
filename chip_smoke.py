"""Smoke run of junctiontree_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version at the shapes the serving path gives it (with its
time beside the plain version's, one PyTorch ``einsum`` call's and the
card's bound) and at edge shapes, then serves evidence batches through the
public entry points (``create_junction_tree(...).engine(...)
.set_potentials(...).posterior_batch(masks)``), one phase per path:

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
* ``fused_serving``: a 1,000-leaf star, B = 1024, auto mode (the level-fused
  program), and the 8x8 grid, B = 4096, ``mode="fused"`` against
  ``mode="general"``;
* ``chunked_serving``: ``hailfinder_like()`` B = 256 with ``chunk=128``
  against two B = 128 calls, and the 8x8 grid with the distribute-pass
  division on against off.

With ``--profile`` the serving models also print their device time by
kernel (``torch.profiler``).  Each phase prints one JSON line; the kernel
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


# published peaks of one H100 SXM: f32 outside the tensor cores, bf16 dense
# on the tensor cores (operations a second), device memory (bytes a second)
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12


def kernel_bound_ms(R1, R2, C, B, bf16):
    """Least time the card could take for one contraction: the larger of
    its operations over the peak rate of their type and its bytes (each
    input read once, the output written once) over the memory rate."""
    ops = 2 * B * R1 * R2 * C + 2 * B * R1 * C
    item = 2 if bf16 else 4
    nbytes = item * (R1 * R2 * C + B * R2) + 4 * (B * R1 + B * C)
    t_ops = ops / (PEAK_BF16 if bf16 else PEAK_F32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


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
    with the most time as [name, launches per step, ms per step])."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count / steps, e.device_time_total / steps / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[2])
    return (sum(r[2] for r in rows), sum(r[1] for r in rows),
            [[k[:60], n, ms] for k, n, ms in rows[:8]])


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


def serving_shapes(plan, masks):
    """(R1, R2, C, B) of every kernel call one posterior_batch on ``plan``
    makes, from a run on meta tensors (shapes only, nothing computed)."""
    import torch

    from junctiontree_tpu_torch.executor import BatchedProgramBuilder
    from junctiontree_tpu_torch.ops import factored_contract as fc

    shapes = []
    wrapped = fc.factored_masked_contract

    def record(pot, w1, w2):
        shapes.append(tuple(int(d) for d in pot.shape) + (int(w1.shape[0]),))
        return wrapped(pot, w1, w2)

    ids = sorted(plan.table.id_of(k) for k in masks)
    pots = [torch.empty(plan.clique_shape(c), device="meta")
            for c in range(plan.tri.num_cliques)]
    meta_masks = [torch.empty(masks[plan.table.label_of(v)].shape, device="meta")
                  for v in ids]
    fc.factored_masked_contract = record
    try:
        BatchedProgramBuilder(plan, observed=ids, rescale=True).full()(
            pots, meta_masks)
    finally:
        fc.factored_masked_contract = wrapped
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


def k1_counts_reset():
    """Set the kernel wrapper's launch counts to 0; returns the wrapper."""
    from junctiontree_tpu_torch.ops.factored_contract import (
        factored_masked_contract as k1,
    )

    k1.launches = k1.launches_bf16 = 0
    return k1


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
    k1 = k1_counts_reset()
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
              "kernels_per_step": n_kernels, "top_kernels": top})
    emit({"phase": "bf16_serving", "B": B, "kernel_launches": launches,
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
            k1 = k1_counts_reset()
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
    chain against the general program."""
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
    k1 = k1_counts_reset()
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
    k1 = k1_counts_reset()
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on the GPU only", file=sys.stderr)
        return 2
    import numpy as np

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.models import hailfinder_like, sprinkler_model
    from junctiontree_tpu_torch.ops import cuda_build
    from junctiontree_tpu_torch.ops import factored_contract as fc
    from junctiontree_tpu_torch.utils.bench_kernel import device_ms, host_us

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    mma = cuda_build.tensor_core_op_counts()
    require(all(n == 0 for k, n in mma.items() if not k.startswith("bf16"))
            and all(n > 0 for k, n in mma.items() if k.startswith("bf16")),
            f"tensor-core operations outside the bf16 kernels: {mma}")
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(cuda_build.build_seconds, 3),
          "library": cuda_build.library_path(), "ptxas": regs[:16],
          "tensor_core_op_counts": mma})

    # -- 3. kernel against the plain version ---------------------------------
    factors, sizes, values, names = big_clique_model()
    tree = jt.create_junction_tree(factors, sizes)
    plan = tree.plan
    B = 4096
    evs = jt.random_evidence_batch(plan, B, names[:12], seed=1)
    masks = jt.batch_masks_sparse(plan, evs)
    masks[names[0]][0] = 0.0  # row 0: impossible evidence
    main_shapes = serving_shapes(plan, masks)
    require(len(main_shapes) > 0, "the big-clique program routes no kernel call")
    per_call = {s: main_shapes.count(s) for s in main_shapes}
    # edges: R1 = 1, ragged, C = 300 (r1 looped in the block), B = 70,000,
    # rows that are not 16-byte aligned in w2, in pot, in both tilings
    edge_shapes = [(1, 37, 1, 5), (3, 50, 17, 33), (5, 70, 300, 130),
                   (64, 4095, 1, 4097), (2, 40, 3, 70000), (4, 37, 3, 130),
                   (3, 64, 3, 40), (2, 64, 50, 100)]
    g = torch.Generator(device=dev).manual_seed(0)

    def rand_pot(R1, R2, C, dtype, as_handed=True):
        """pot [R1, R2, C]; as_handed: in the memory layout that
        big_clique_sep_message hands the kernel (no copy in the wrapper)."""
        if as_handed and fc.tiles_by_n(C):
            return torch.rand((R2, R1, C), generator=g,
                              device=dev).to(dtype).permute(1, 0, 2)
        return torch.rand((R1, R2, C), generator=g, device=dev).to(dtype)

    # per dtype, summed over one big-clique step's launches
    totals = {bf16: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                         bound_ops_ms=0.0, max_abs_err=0.0)
              for bf16 in (False, True)}
    for shape in list(per_call) + edge_shapes:
        R1, R2, C, Bk = shape
        serving = shape in per_call
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            # an edge shape also takes the wrapper's one-copy path
            pot = rand_pot(R1, R2, C, dtype, as_handed=serving)
            w1 = torch.rand((Bk, R1), generator=g, device=dev).to(dtype)
            w2 = torch.rand((Bk, R2), generator=g, device=dev).to(dtype)
            got = fc.factored_masked_contract(pot, w1, w2)
            want = fc.reference_factored_contract(pot, w1, w2)
            torch.cuda.synchronize()
            abs_err = (got - want).abs().max().item()
            rel = abs_err / want.abs().max().item()
            tol = 2e-2 if bf16 else 1e-5
            require(rel <= tol, f"kernel disagrees at {shape} {dtype}: {rel}")
            line = {"phase": "kernel_vs_plain", "R1": R1, "R2": R2, "C": C,
                    "B": Bk, "dtype": str(dtype).split(".")[-1],
                    "max_abs_err": abs_err, "rel_err": rel, "tol": tol,
                    "on_serving_path": serving}
            if serving:
                again = fc.factored_masked_contract(pot, w1, w2)
                require(torch.equal(got, again), f"two runs differ at {shape}")
                k = device_ms(lambda: fc.factored_masked_contract(pot, w1, w2))
                p = device_ms(lambda: fc.reference_factored_contract(pot, w1, w2))
                # the one PyTorch call for the same function (TF32 is off);
                # a yardstick only: the package never calls it
                lib = device_ms(
                    lambda: torch.einsum("rsc,br,bs->bc", pot, w1, w2))
                bound, by = kernel_bound_ms(R1, R2, C, Bk, bf16)
                line.update(
                    ms=k, plain_ms=p, library_ms=lib, bound_ms=bound,
                    bound_by=by, share_of_bound=bound / k,
                    host_us_per_call=host_us(
                        lambda: fc.factored_masked_contract(pot, w1, w2)),
                    calls_per_step=per_call[shape])
                n, tot = per_call[shape], totals[bf16]
                tot["ms"] += k * n
                tot["plain_ms"] += p * n
                tot["library_ms"] += lib * n
                tot["bound_ms"] += bound * n
                tot["bound_ops_ms"] += bound * n * (by == "operations")
                tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
            emit(line)

    # the serving floor 1e-38 is subnormal in f32 and bf16: it must not be
    # flushed, and exact zeros must stay exact zeros
    for dtype in (torch.float32, torch.bfloat16):
        R1, R2, C, Bk = next(iter(per_call))
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

    # -- 4. big-clique serving (the main path) -------------------------------
    eng = tree.engine(device=dev).set_potentials(values)
    k1 = k1_counts_reset()
    (post, logz), peak_big = peak_bytes(lambda: eng.posterior_batch(masks))
    launches = k1.launches
    require(k1.launches_bf16 == 0,
            "the float32 engine launched the bf16 kernel")
    require(launches == len(main_shapes),
            f"{launches} kernel launches, expected {len(main_shapes)}")
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
              "kernels_per_step": n_kernels, "top_kernels": top})
    emit({"phase": "big_clique_serving", "B": B, "cliques": plan.tri.num_cliques,
          "max_clique_states": plan.stats()["max_clique_states"],
          "kernel_launches": launches, "step_ms": t_big,
          "queries_per_s": B / t_big * 1e3, "peak_mem_bytes": peak_big,
          "max_abs_err_vs_f64": worst, "rows_checked": rows})
    del ref, ref_post

    # -- 4b. the same model with bfloat16 storage ---------------------------
    launches_bf16 = phase_bf16(dev, tree, values, masks, post, logz,
                               t_big, peak_big, len(main_shapes), profile)
    del eng, post

    # -- 5. classic-network serving (hailfinder_like, einsum route) ----------
    factors, sizes, values = hailfinder_like(seed=0)
    tree = jt.create_junction_tree(factors, sizes)
    plan = tree.plan
    Bh = 128
    labels = [plan.table.label_of(v) for v in range(plan.num_vars)][::3]
    masks = jt.batch_masks_sparse(
        plan, jt.random_evidence_batch(plan, Bh, labels, seed=2))
    masks[labels[0]][1] = 0.0  # row 1: impossible evidence
    eng = tree.engine(device=dev).set_potentials(values)
    k1 = k1_counts_reset()
    (post, logz), peak = peak_bytes(lambda: eng.posterior_batch(masks))
    hail_launches = k1.launches
    rows = 16
    ref = tree.engine(device=dev, dtype=torch.float64).set_potentials(values)
    ref_post, ref_logz = ref.posterior_batch(
        {k: v[:rows] for k, v in masks.items()})
    worst_h = check_close(post, logz, ref_post, ref_logz, len(post),
                          "hailfinder_like vs float64", rows=rows, **F64_LIMITS)
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
    del ref, ref_post
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
    del post
    torch.cuda.empty_cache()
    phase_chain(dev, profile)
    grid = phase_fused(dev, profile)
    phase_chunked(dev, eng, plan, grid)
    del eng, grid

    # -- 7. kernel table, card, result --------------------------------------
    # the kernel once per dtype it serves; launches are those of that
    # dtype's serving phase, times are sums over one big-clique step
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
        "per": "one big-clique step (%d launches), %s" % (
            n_launched, "bfloat16 storage" if bf16 else "float32"),
    } for bf16, n_launched, tot in (
        (False, launches, totals[False]), (True, launches_bf16, totals[True]))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
