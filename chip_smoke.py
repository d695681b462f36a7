"""Smoke run of junctiontree_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version at the shapes the serving path gives it (with its
time beside the plain version's, one PyTorch ``einsum`` call's and the
card's bound) and at edge shapes, then serves evidence batches through the public entry points
(``create_junction_tree(...).engine(device="cuda").set_potentials(...)
.posterior_batch(masks)``) on two models:

* the single 2^18-state clique (18 binary variables, one dense factor plus
  18 unaries, evidence on 12), B = 4096: every big contraction runs the
  kernel;
* ``hailfinder_like()`` (56 variables, largest clique 12.4M states),
  B = 128, evidence on every third variable: the planned-einsum route at the
  size of the largest in-repo network.

With ``--profile`` each serving model also prints its device time by kernel
(``torch.profiler``).  Each phase prints one JSON line; the kernel table and the card's name and
power limit come before the last line, which is
``{"ok": true, "device": {...}}``.  Any failure raises, and the script exits
non-zero without that line.  It needs a CUDA device and never falls back to
the CPU.
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
        BatchedProgramBuilder(plan, observed=ids).full()(
            pots, meta_masks)
    finally:
        fc.factored_masked_contract = wrapped
    return shapes


def check_against_f64(post, logz, ref_post, ref_logz, rows, what):
    import numpy as np

    lz = logz[:rows].double().cpu().numpy()
    rlz = ref_logz.cpu().numpy()
    require(np.array_equal(np.isneginf(lz), np.isneginf(rlz)),
            f"{what}: -inf rows differ from the float64 run")
    fin = np.isfinite(rlz)
    np.testing.assert_allclose(lz[fin], rlz[fin], rtol=0, atol=1e-4,
                               err_msg=f"{what}: logZ")
    worst = 0.0
    for p, rp in zip(post, ref_post):
        p = p[:rows].double().cpu().numpy()
        rp = rp.cpu().numpy()
        require(np.isfinite(p).all(), f"{what}: non-finite posterior")
        np.testing.assert_allclose(p, rp, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what}: posteriors")
        worst = max(worst, float(np.abs(p - rp).max()))
    return worst


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

    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    max_abs_err = 0.0
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
                if not bf16:
                    n = per_call[shape]
                    totals["ms"] += k * n
                    totals["plain_ms"] += p * n
                    totals["library_ms"] += lib * n
                    totals["bound_ms"] += bound * n
                    max_abs_err = max(max_abs_err, abs_err)
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
    fc.factored_masked_contract.launches = 0
    post, logz = eng.posterior_batch(masks)
    torch.cuda.synchronize()
    launches = fc.factored_masked_contract.launches
    require(launches == len(main_shapes),
            f"{launches} kernel launches, expected {len(main_shapes)}")
    rows = 64
    ref = tree.engine(device=dev, dtype=torch.float64).set_potentials(values)
    ref_post, ref_logz = ref.posterior_batch(
        {k: v[:rows] for k, v in masks.items()})
    worst = check_against_f64(post, logz, ref_post, ref_logz, rows,
                              "big clique")
    require(bool(torch.isneginf(logz[0])), "impossible row: logZ is not -inf")
    require(all(bool((p[0] == 0).all()) for p in post),
            "impossible row: posteriors are not zero")
    require(all(tuple(p.shape) == (B, 2) for p in post), "posterior shapes")
    t_big = step_ms(lambda: eng.posterior_batch(masks))
    if "--profile" in sys.argv[1:]:
        busy, n_kernels, top = profile_step(lambda: eng.posterior_batch(masks))
        emit({"phase": "profile", "model": "big_clique", "step_ms": t_big,
              "device_busy_ms_per_step": busy,
              "kernels_per_step": n_kernels, "top_kernels": top})
    emit({"phase": "big_clique_serving", "B": B, "cliques": plan.tri.num_cliques,
          "max_clique_states": plan.stats()["max_clique_states"],
          "kernel_launches": launches, "step_ms": t_big,
          "queries_per_s": B / t_big * 1e3, "max_abs_err_vs_f64": worst,
          "rows_checked": rows})

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
    torch.cuda.reset_peak_memory_stats(dev)
    fc.factored_masked_contract.launches = 0
    post, logz = eng.posterior_batch(masks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    hail_launches = fc.factored_masked_contract.launches
    rows = 16
    ref = tree.engine(device=dev, dtype=torch.float64).set_potentials(values)
    ref_post, ref_logz = ref.posterior_batch(
        {k: v[:rows] for k, v in masks.items()})
    worst_h = check_against_f64(post, logz, ref_post, ref_logz, rows,
                                "hailfinder_like")
    require(bool(torch.isneginf(logz[1])), "impossible row: logZ is not -inf")
    require(all(bool((p[1] == 0).all()) for p in post),
            "impossible row: posteriors are not zero")
    t_hail = step_ms(lambda: eng.posterior_batch(masks), iters=5)
    if "--profile" in sys.argv[1:]:
        busy, n_kernels, top = profile_step(
            lambda: eng.posterior_batch(masks), steps=2)
        emit({"phase": "profile", "model": "hailfinder_like", "step_ms": t_hail,
              "device_busy_ms_per_step": busy,
              "kernels_per_step": n_kernels, "top_kernels": top})
    del eng, ref, post, ref_post
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

    # -- 6. kernel table, card, result --------------------------------------
    emit({"kernels": [{
        "name": "factored_masked_contract", "route": "cuda",
        "source": "junctiontree_tpu_torch/csrc/factored_contract.cu",
        "replaces": "junctiontree_tpu/ops/pallas_contract.py:286",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": "operations",
        "library_ms": totals["library_ms"],
        "per": "one big-clique step (%d launches), float32" % launches,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
