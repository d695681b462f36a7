"""Time the factored big-clique kernel alone on one NVIDIA GPU.

    python junctiontree_tpu_torch/utils/bench_kernel.py [--root DIR] [--label NAME] [--step | --map | --chain]

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
reads the kept operand.  ``--map`` prints instead the tree-MAP program's
step and its fused collects against the plain ones (:func:`map_lines`),
``--chain`` the chain program's step (the library's product and the row
kernel) against its plain step, the product and ``reference_rows``
(:func:`chain_lines`).
``--step`` adds one line per dtype for a whole
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
    ap.add_argument("--map", action="store_true",
                    help="time only the tree-MAP program and its collects")
    ap.add_argument("--chain", action="store_true",
                    help="time only the chain program's step")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bench_kernel: no CUDA device", file=sys.stderr)
        return 2
    from junctiontree_tpu_torch.ops import factored_contract as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.map or args.chain:
        for line in (map_lines(dev) if args.map else chain_lines(dev)):
            print(json.dumps({"label": args.label, **line}), flush=True)
        return 0
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
    from junctiontree_tpu_torch.utils.timing import TIMERS

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
    before = TIMERS.counters()
    eng.posterior_batch(masks)
    torch.cuda.synchronize()
    after = TIMERS.counters()
    launches, splits = (after[n] - before[n] for n in (
        "factored_masked_contract.launches",
        "factored_masked_contract.splits"))
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


# the card's FP32 lanes and boost clock, and its HBM rate (H100 SXM): the
# fused collect's bound
FP32_LANES, SM_CLOCK_HZ, HBM_BYTES_S = 132 * 128, 1.98e9, 3.35e12


def collect_bound_ms(b, states, n_addends, operand_bytes) -> float:
    """The fused collect's bound on the card: the larger of its bytes (the
    potential, ``operand_bytes`` of masks and messages, and the [b] keys)
    over the HBM rate and its FP32 instructions (b x states x (addends +
    one compare)) over the lanes at the boost clock."""
    return 1e3 * max((4 * states + operand_bytes + 8 * b) / HBM_BYTES_S,
                     b * states * (n_addends + 1) / (FP32_LANES * SM_CLOCK_HZ))


def collect_pairs(eng, masks):
    """Each clique of the tree-MAP program of ``eng`` (a float32
    max-product engine on the card) on the log ``masks``, in the program's
    order: (clique, fused, plain, bound_ms), the fused collect
    (``map_collect.collect``) and the plain one
    (``map_executor._collect_plain``) as calls on the same inputs (the
    children's messages come from the fused collect), each returning
    (scores, indices) in the plain path's layout."""
    import torch

    from junctiontree_tpu_torch import map_executor as mx
    from junctiontree_tpu_torch.ops import map_collect

    plan, tree = eng.plan, eng.plan.tree
    ids, placed = eng._log_mask_args(masks)
    cmv = mx.clique_mask_vars(plan, list(ids))
    lay = mx._layout(plan)
    fls = mx._fused_layouts(plan, cmv, lay)
    slot = {v: i for i, v in enumerate(ids)}
    msgs = {}
    out = []
    for c in reversed(tree.topo_order):
        kids = [(plan.sep_vars[s], msgs.pop(ch)) for ch, s in tree.children[c]]
        own = [placed[slot[v]] for v in cmv[c]]

        def fused(c=c, own=own, kids=kids):
            vals, idx = map_collect.collect(fls[c], eng._pots[c], own,
                                            [m for _, m in kids])
            if c == tree.root:
                return vals[0], idx[0].to(torch.int64)
            return vals.t(), idx.t()

        def plain(c=c, kids=kids):
            return mx._collect_plain(plan, c, eng._pots, placed, slot, cmv[c],
                                     kids, lay.get(c))

        vals, _ = fused()
        if c != tree.root:
            msgs[c] = vals
        ops = sum(4 * m.numel() for m in own) + sum(
            4 * m.numel() for _, m in kids)
        out.append((c, fused, plain, collect_bound_ms(
            vals.shape[0], fls[c].states, fls[c].n_addends, ops)))
    return out


def map_lines(dev, B=4096):
    """``--map``: the tree-MAP program on the card, float32, B = 4,096
    rows, on the 2^18-state clique (18 binary variables, one-hot masks on
    12, row 0 impossible) and the 8x8 grid (evidence on every fourth
    variable): the program's step ms (host clock to a sync, median of 12
    calls) and device ms, and over its cliques (:func:`collect_pairs`) the
    sums of the fused and the plain collects' device ms and of their
    bounds, and whether the two gave the same bits."""
    import numpy as np
    import torch

    import junctiontree_tpu_torch as jt
    from junctiontree_tpu_torch.models import grid_mrf_model

    rng = np.random.default_rng(0)
    names = [f"v{i}" for i in range(18)]
    clique = ([names[:]] + [[n] for n in names], {n: 2 for n in names},
              [rng.random((2,) * 18) + 0.1] + [rng.random(2) + 0.1
                                                for _ in names], names[:12])
    gf, gs, gv = grid_mrf_model(8, 8, seed=0)
    grid = (gf, gs, gv, sorted(gs)[::4])
    out = []
    for label, (f, s, v, observed) in (("bigclique18", clique),
                                       ("grid8x8", grid)):
        eng = jt.create_junction_tree(f, s).engine(
            "max_product", device=dev, dtype=torch.float32).set_potentials(v)
        masks = {}
        for k in observed:
            m = np.full((B, s[k]), -np.inf, dtype=np.float32)
            m[np.arange(B), rng.integers(0, s[k], B)] = 0.0
            masks[k] = m
        masks[observed[0]][0] = -np.inf

        def run():
            return eng.map_assignment_batch(masks)

        run()
        steps = []
        for _ in range(12):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
        line = {"map": label, "B": B, "cliques": len(eng.plan.clique_vars),
                "device": torch.cuda.get_device_name(0),
                "step_ms": statistics.median(steps),
                "device_ms": device_ms(run, iters=5),
                "fused_collects_ms": 0.0, "plain_collects_ms": 0.0,
                "collects_bound_ms": 0.0, "same_bits": True}
        for _, fused, plain, bound in collect_pairs(eng, masks):
            (fv, fi), (pv, pi) = fused(), plain()
            line["same_bits"] &= bool(
                torch.equal(fv.view(torch.int32), pv.view(torch.int32))
                and torch.equal(fi.long(), pi.long()))
            line["fused_collects_ms"] += device_ms(fused, iters=5)
            line["plain_collects_ms"] += device_ms(plain, iters=5)
            line["collects_bound_ms"] += bound
        out.append(line)
        del eng
        torch.cuda.empty_cache()
    return out


FP32_TFLOPS = 66.9  # one H100 SXM's FP32 FMA rate on the CUDA cores


def chain_lines(dev, B=16384, K=500):
    """``--chain``: one chain step at the HMM cell's shape ([B, K] x [K, K],
    float32, TF32 off): the step's device ms forward and backward
    (``ops.chain_step``: the library's product, then the row kernel), the
    plain step (the product, then ``chain_step.reference_rows``: what the
    CPU, float64 and K > 1024 run), the library's product alone
    (``torch.matmul``, A and its transposed view), the row kernel alone,
    and the FP32 bound of the product; with the step's largest error
    against its plain version in float32 and in float64 on the same
    inputs, over max |plain|.  The inputs: a
    row-stochastic A, masks in [0, 1] and messages in (0, 1]."""
    import torch

    from junctiontree_tpu_torch.ops import chain_step

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    A = rand(K, K)
    A /= A.sum(dim=1, keepdim=True)
    F, M, Gn, Mp = rand(B, K), rand(B, K), rand(B, K), rand(B, K)
    FM, XM, MG = F * Mp, F * M, M * Gn
    out, scale = torch.empty_like(F), torch.empty((B, 1), device=dev)
    post = torch.empty_like(F)

    def err(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    def fwd():
        chain_step.forward_step(XM, A, Mp, out, scale)

    def bwd():
        post.copy_(FM)
        chain_step.backward_step(MG, A, Mp, out, post)

    fwd()
    got_f, got_s = out.clone(), scale.clone()
    bwd()
    got_g, got_p = out.clone(), post.clone()
    errs = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).replace("torch.", "")
        y = torch.matmul(XM.to(dt), A.to(dt))
        s = torch.empty((B, 1), dtype=dt, device=dev)
        chain_step.reference_rows(y, Mp.to(dt), scale=s)
        errs["forward_vs_plain_" + name] = max(err(got_f, y), err(got_s, s))
        y = torch.matmul(MG.to(dt), A.to(dt).t())
        p = FM.to(dt, copy=True)
        chain_step.reference_rows(y, Mp.to(dt), post=p)
        errs["backward_vs_plain_" + name] = max(err(got_g, y),
                                                err(got_p, p))

    def plain_fwd():
        torch.matmul(XM, A, out=out)
        chain_step.reference_rows(out, Mp, scale=scale)

    def plain_bwd():
        post.copy_(FM)
        torch.matmul(MG, A.t(), out=out)
        chain_step.reference_rows(out, Mp, post=post)

    def copy():
        post.copy_(F)

    At = A.t()
    line = {"chain_step": "B=%d K=%d" % (B, K),
            "device": torch.cuda.get_device_name(0),
            "step_ms_forward": device_ms(fwd),
            "step_ms_backward": device_ms(bwd) - device_ms(copy),
            "plain_ms_forward": device_ms(plain_fwd),
            "plain_ms_backward": device_ms(plain_bwd) - device_ms(copy),
            "library_product_ms": device_ms(
                lambda: torch.matmul(F, A, out=out)),
            "library_product_ms_transposed": device_ms(
                lambda: torch.matmul(F, At, out=out)),
            "rows_ms_forward": device_ms(
                lambda: chain_step.rows(out, Mp, scale=scale)),
            "rows_ms_backward": device_ms(
                lambda: chain_step.rows(out, Mp, post=post)),
            "bound_ms": 2 * B * K * K / (FP32_TFLOPS * 1e12) * 1e3,
            **errs}
    line["share_of_bound"] = {
        k: line["bound_ms"] / line[k]
        for k in ("step_ms_forward", "step_ms_backward",
                  "library_product_ms", "library_product_ms_transposed")}
    return [line]


if __name__ == "__main__":
    sys.exit(main())
