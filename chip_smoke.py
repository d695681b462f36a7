"""Smoke run of junctiontree_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version at the shapes the serving path gives it, then
serves evidence batches through the public entry points
(``create_junction_tree(...).engine(device="cuda").set_potentials(...)
.posterior_batch(masks)``) on two models:

* the single 2^18-state clique (18 binary variables, one dense factor plus
  18 unaries, evidence on 12), B = 4096: every big contraction runs the
  kernel;
* ``hailfinder_like()`` (56 variables, largest clique 12.4M states),
  B = 128, evidence on every third variable: the planned-einsum route at the
  size of the largest in-repo network.

Each phase prints one JSON line; the kernel table and the card's name and
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


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events per run)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(cuda_build.build_seconds, 3),
          "library": cuda_build.library_path(), "ptxas": regs[:16]})

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
    edge_shapes = [(1, 37, 1, 5), (3, 50, 17, 33), (5, 70, 300, 130),
                   (64, 4095, 1, 4097), (2, 40, 3, 70000)]
    g = torch.Generator(device=dev).manual_seed(0)
    kernel_ms = plain_ms = 0.0
    max_abs_err = 0.0
    for shape in list(per_call) + edge_shapes:
        R1, R2, C, Bk = shape
        for dtype in (torch.float32, torch.bfloat16):
            pot = torch.rand((R1, R2, C), generator=g, device=dev).to(dtype)
            w1 = torch.rand((Bk, R1), generator=g, device=dev).to(dtype)
            w2 = torch.rand((Bk, R2), generator=g, device=dev).to(dtype)
            got = fc.factored_masked_contract(pot, w1, w2)
            want = fc.reference_factored_contract(pot, w1, w2)
            torch.cuda.synchronize()
            abs_err = (got - want).abs().max().item()
            rel = abs_err / want.abs().max().item()
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            require(rel <= tol, f"kernel disagrees at {shape} {dtype}: {rel}")
            line = {"phase": "kernel_vs_plain", "R1": R1, "R2": R2, "C": C,
                    "B": Bk, "dtype": str(dtype).split(".")[-1],
                    "max_abs_err": abs_err, "rel_err": rel, "tol": tol,
                    "on_serving_path": shape in per_call}
            if shape in per_call:
                k = cuda_ms(lambda: fc.factored_masked_contract(pot, w1, w2))
                p = cuda_ms(lambda: fc.reference_factored_contract(pot, w1, w2))
                line.update(ms=k, plain_ms=p, calls_per_step=per_call[shape])
                if dtype == torch.float32:
                    kernel_ms += k * per_call[shape]
                    plain_ms += p * per_call[shape]
                    max_abs_err = max(max_abs_err, abs_err)
            emit(line)

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
        "ms": kernel_ms, "plain_ms": plain_ms,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
