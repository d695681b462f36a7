"""Time the factored big-clique kernel alone on one NVIDIA GPU.

    python junctiontree_tpu_torch/utils/bench_kernel.py [--root DIR] [--label NAME] [--step]

Prints one JSON line per shape and dtype: the serving shapes of the
2^18-state clique, one model shard of each (``Engine.shard_model`` over 4
model shards: R1 = 16), the weight gradients ``dw1`` and ``dw2`` at the
serving shape (the kernel on a permuted potential), the joints over two
and three variables and the E-step's forward shapes; the kernel's device
time (a float32 call includes its pot split) beside its plain version's,
``library_factored_contract``'s (two library products) and one
``torch.einsum``'s, all taken with the host running ahead of the card, the
host's own time to queue one call, and a SHA-256 of the output's bytes
(the inputs come from one seed, so two versions' digests say whether they
gave the same bits).  Where the package has ``StandingLayout`` (a standing
potential whose split is kept), also the time and host time of a call that
reads the kept operand.  ``--step`` adds one line per dtype for a whole
``posterior_batch`` of the 2^18-state clique at B = 4096 (step ms, device
time and launches by kernel from ``torch.profiler``, copy kernels, kernel
launches and pot splits a steady call).  ``--root`` names another checkout
of this repository whose package is timed instead, so that two versions
can be compared on one card in one process sequence (parent, change,
change, parent).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

SHAPES = [(64, 2048, 2, 4096), (64, 4096, 1, 4096),    # (R1, R2, C, B)
          (16, 2048, 2, 4096), (16, 4096, 1, 4096),    # model shards
          (2, 2048, 64, 4096), (2, 64, 2048, 4096),    # dw1, dw2
          (64, 512, 8, 4096), (64, 1024, 4, 4096),     # joints over 3, 2
          (512, 512, 1, 4096), (512, 256, 2, 4096)]    # E-step forward


def device_ms(fn, iters=20, repeats=5, spin_cycles=20_000_000):
    """Device milliseconds of one ``fn()``: CUDA events around ``iters``
    calls queued behind a spin kernel, so that the host runs ahead and its
    own time per call does not count; median of ``repeats``.  The spin
    (``spin_cycles``, 20 million: about 10 ms of device time) must outlast
    the host's time to queue all ``iters`` calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def host_us(fn, iters=200):
    """Host microseconds to queue one ``fn()`` (no synchronisation inside)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose junctiontree_tpu_torch is timed")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--step", action="store_true",
                    help="also profile one posterior_batch of the big clique")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bench_kernel: no CUDA device", file=sys.stderr)
        return 2
    from junctiontree_tpu_torch.ops import factored_contract as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for R1, R2, C, B in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            # [R2, R1, C] in memory where the package says its kernel reads
            # rows of r2 (no copy in the wrapper), else [R1, R2, C]
            by_rows = getattr(fc, "tiles_by_n", lambda c: False)(C)
            pot = torch.rand((R2, R1, C) if by_rows else (R1, R2, C),
                             generator=g, device=dev).to(dtype)
            pot = pot.permute(1, 0, 2) if by_rows else pot
            # w1 in float32, as the serving route hands it to the kernel
            w1 = torch.rand((B, R1), generator=g, device=dev)
            w2 = torch.rand((B, R2), generator=g, device=dev).to(dtype)
            got = fc.factored_masked_contract(pot, w1, w2)
            want = fc.reference_factored_contract(pot, w1, w2)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            kept = partial_sums(fc, R1, R2, C, B, dtype, dev)
            if hasattr(fc, "StandingLayout"):
                if hasattr(fc, "standing"):
                    fc.standing(pot, 1)
                lay = fc.StandingLayout(pot, [0], [1], [2], by_rows)
                kept.update({"kept_ms": device_ms(
                            lambda: fc.factored_masked_contract(lay, w1, w2)),
                        "kept_host_us_per_call": host_us(
                            lambda: fc.factored_masked_contract(lay, w1, w2)),
                        "kept_same_bits": bool(torch.equal(
                            fc.factored_masked_contract(lay, w1, w2), got))})
            print(json.dumps({
                "label": args.label, "package": os.path.dirname(fc.__file__),
                "device": torch.cuda.get_device_name(0),
                "R1": R1, "R2": R2, "C": C, "B": B,
                "dtype": str(dtype).split(".")[-1], "rel_err": rel,
                "kernel_ms": device_ms(
                    lambda: fc.factored_masked_contract(pot, w1, w2)),
                "plain_ms": device_ms(
                    lambda: fc.reference_factored_contract(pot, w1, w2)),
                "library_ms": device_ms(
                    lambda: fc.library_factored_contract(pot, w1, w2)),
                "einsum_ms": device_ms(lambda: torch.einsum(
                    "rsc,br,bs->bc", pot, w1.to(dtype), w2)),
                "host_us_per_call": host_us(
                    lambda: fc.factored_masked_contract(pot, w1, w2)),
                "out_sha256": hashlib.sha256(
                    got.cpu().numpy().tobytes()).hexdigest(),
                **kept,
            }), flush=True)
    if args.step:
        for dtype in (torch.float32, torch.bfloat16):
            print(json.dumps({"label": args.label, **step_line(dev, dtype)}),
                  flush=True)
    return 0


# K1's kernels by name: the contraction kernels, the pot split, and a
# separate sum kernel where a version has one
K1_KERNELS = ("factored_contract_tc_kernel", "factored_contract_fma_kernel",
              "split_pot_kernel", "split_sum_kernel")


def partial_sums(fc, R1, R2, C, B, dtype, dev) -> dict:
    """The r2 partials a tile of this call leaves on this card (``nparts``)
    and, where there are several, the time of the one PyTorch call that
    adds them (``ws.sum(0)`` over [nparts, B, C] float32) beside the
    bytes bound of that sum (3.35 TB/s)."""
    import functools

    import torch

    bf16 = dtype == torch.bfloat16
    src = fc.source(bf16, "highest", R1 * C if fc.tiles_by_n(C) else None)
    cfg = fc.launch_config(B, R1, R2, C, fc._sm_count(dev), bf16,
                           functools.partial(fc._cluster_slots, dev, src))
    line = {"nparts": cfg["nparts"]}
    if cfg["nparts"] > 1:
        ws = torch.rand((cfg["nparts"], B, C), device=dev)
        line.update(sum_library_ms=device_ms(lambda: ws.sum(0)),
                    sum_bound_ms=4 * (cfg["nparts"] + 1) * B * C / 3.35e12
                    * 1e3)
    return line


def step_line(dev, dtype) -> dict:
    """One steady ``posterior_batch`` of the 2^18-state clique (18 binary
    variables, evidence on 12, B = 4096) stored in ``dtype``: host ms of a
    call that ends in a sync (median of 10), device time and launches by
    kernel over 5 calls (``torch.profiler``), and the kernel's launches and
    pot splits in one call after the engine's first."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.ops import factored_contract as fc

    rng = np.random.default_rng(0)
    names = [f"v{i}" for i in range(18)]
    values = [rng.random((2,) * 18).astype(np.float32) + 0.1] + [
        rng.random(2) + 0.1 for _ in names]
    tree = jt.create_junction_tree([names[:]] + [[n] for n in names],
                                   {n: 2 for n in names})
    masks = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, 4096, names[:12], seed=1))
    eng = tree.engine(device=dev, dtype=dtype).set_potentials(values)
    eng.posterior_batch(masks)
    torch.cuda.synchronize()
    k1 = fc.factored_masked_contract
    before = (k1.launches, k1.splits)
    eng.posterior_batch(masks)
    torch.cuda.synchronize()
    launches, splits = k1.launches - before[0], k1.splits - before[1]
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.posterior_batch(masks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.posterior_batch(masks)
        torch.cuda.synchronize()
    # the program's spans lie on the device lanes too (user annotations)
    rows = [(e.key, e.count / steps, e.device_time_total / steps / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    k1_rows = [r for r in rows if any(k in r[0] for k in K1_KERNELS)]
    return {"step": "posterior_batch, 2^18-state clique, B = 4096",
            "dtype": str(dtype).split(".")[-1],
            "device": torch.cuda.get_device_name(0),
            "step_ms": statistics.median(times),
            "device_busy_ms_per_step": sum(r[2] for r in rows),
            "kernels_per_step": sum(r[1] for r in rows),
            "copy_kernels_per_step": sum(
                r[1] for r in rows if "copy" in r[0].lower()),
            "k1_device_ms_per_step": sum(r[2] for r in k1_rows),
            "k1_kernels_per_step": sum(r[1] for r in k1_rows),
            "k1_by_kernel": [[next(f for f in K1_KERNELS if f in k), n, ms]
                             for k, n, ms in k1_rows],
            "kernel_launches": launches, "pot_splits": splits}


if __name__ == "__main__":
    sys.exit(main())
