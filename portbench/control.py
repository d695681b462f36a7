"""The readings that a cell's limits are set from, on many seeds in one
process, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ...

For each seed: the program's answers on the rows a run judges (its
``sound`` reading) and the control's answers on the same rows (its
``control`` reading), each compared with the float64 reference.  The
control is the mix's ``control``: the reference in float32 with TF32
matrix products ("reference_tf32") or the reference in bfloat16
("reference_bf16").  Prints one JSON line per seed,
then the largest sound and the smallest control reading of each number.
"""

from __future__ import annotations

import json
import os
import sys


def readings(bench, workload, seeds, device, base=None, root=None):
    """Yields {"seed", "sound", "control"} for each seed."""
    import junctiontree_tpu_torch as jt

    from portbench import core, evidence

    base, root = base or core.HERE, root or core.ROOT
    _, cfg, mix = core.cell(bench, workload, base, root)
    gen = core.load_module(base, "models", cfg["generator"])
    surface = core.load_module(base, "surfaces", mix["surface"])
    factors, sizes, values = gen.build(cfg)
    eng = surface.engine(jt, factors, sizes, values, device, cfg)
    kind = mix["control"]

    for seed in seeds:
        inputs = surface.batches(evidence.pool(seed, mix, sizes))
        got, masks = [], []
        for batch, rows in zip(inputs, core.sample_rows(seed, mix)):
            got.append(surface.take(eng, surface.call(eng, batch), rows))
            masks.append({v: m[rows] for v, m in batch.items()})
        got, masks = core._concat(got), core._concat(masks)
        want = surface.reference(factors, sizes, values, masks, device)
        ctl = surface.control(kind, factors, sizes, values, masks, device)
        args = (want, mix["limits"], masks, factors, values)
        yield {"seed": seed, "sound": surface.compare(got, *args)[0],
               "control": surface.compare(ctl, *args)[0]}


def main(argv):
    import argparse

    import torch

    from portbench import core

    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench/control.py: needs a CUDA device", file=sys.stderr)
        return 2
    lines = []
    for line in readings(core.load_benchmark(), args.workload, args.seeds,
                         torch.device("cuda", 0)):
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {"workload": args.workload, "seeds": len(lines),
               "device": torch.cuda.get_device_name(0),
               "sound_max": {k: max(l["sound"][k] for l in lines)
                             for k in lines[0]["sound"]},
               "control_min": {k: min(l["control"][k] for l in lines)
                               for k in lines[0]["control"]}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    sys.exit(main(sys.argv[1:]))
