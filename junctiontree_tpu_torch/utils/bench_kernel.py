"""Time the factored big-clique kernel alone on one NVIDIA GPU.

    python junctiontree_tpu_torch/utils/bench_kernel.py [--root DIR] [--label NAME]

Prints one JSON line per serving shape of the 2^18-state clique and dtype:
the kernel's device time beside its plain version's, both taken with the
host running ahead of the card, and the host's own time to queue one call.
``--root`` names another checkout of this repository whose package is timed
instead, so that two versions can be compared on one card in one process
sequence (parent, change, change, parent).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

SHAPES = [(64, 2048, 2, 4096), (64, 4096, 1, 4096)]  # (R1, R2, C, B)


def device_ms(fn, iters=20, repeats=5):
    """Device milliseconds of one ``fn()``: CUDA events around ``iters``
    calls queued behind a spin kernel, so that the host runs ahead and its
    own time per call does not count; median of ``repeats``."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # about 10 ms of device time
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
            w1 = torch.rand((B, R1), generator=g, device=dev).to(dtype)
            w2 = torch.rand((B, R2), generator=g, device=dev).to(dtype)
            got = fc.factored_masked_contract(pot, w1, w2)
            want = fc.reference_factored_contract(pot, w1, w2)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            print(json.dumps({
                "label": args.label, "package": os.path.dirname(fc.__file__),
                "device": torch.cuda.get_device_name(0),
                "R1": R1, "R2": R2, "C": C, "B": B,
                "dtype": str(dtype).split(".")[-1], "rel_err": rel,
                "kernel_ms": device_ms(
                    lambda: fc.factored_masked_contract(pot, w1, w2)),
                "plain_ms": device_ms(
                    lambda: fc.reference_factored_contract(pot, w1, w2)),
                "host_us_per_call": host_us(
                    lambda: fc.factored_masked_contract(pot, w1, w2)),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
