"""``Engine.map_assignment_batch`` on a max-product engine: MAP decoding.

Compared with the float64 reference on a sample of rows: the largest
absolute gap between the program's score and the reference's best log
score, the largest gap by which the program's assignment, scored by the
reference, falls short of that best, and the rows that break the rule for
impossible evidence (a score below -1e29, never NaN) or hold a NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.evidence import log_masks
from portbench.reference import Reference, row_blocks, score_assignments

_REF_BYTES_PER_STATE = 24
_REF_BUDGET = 8 << 30
INFEASIBLE = -1e29


def batches(pool):
    """The call's inputs: the pool's masks in log space (0 / -inf)."""
    return [log_masks(b) for b in pool]


def engine(jt, factors, sizes, values, device, cfg):
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine("max_product", device=device,
                      dtype=getattr(torch, cfg["dtype"]))
    return eng.set_potentials(values)


def call(eng, batch):
    return eng.map_assignment_batch(batch)


def take(eng, out, rows):
    """The answers of ``rows`` on the host: states per label, and the
    score in float64."""
    assign, score = out
    idx = torch.as_tensor(rows, device=score.device)
    a = assign.index_select(0, idx).cpu().numpy()
    label = eng.plan.table.label_of
    return {"assign": {label(v): a[:, v] for v in range(a.shape[1])},
            "score": score.index_select(0, idx).double().cpu().numpy()}


def reference(factors, sizes, values, masks, device, dtype=torch.float64):
    """The reference's best assignment and log score of every row of
    ``masks``, in blocks."""
    ref = Reference(factors, sizes, values, device, dtype, semiring="max")
    rows = len(next(iter(masks.values())))
    block = max(1, _REF_BUDGET // (_REF_BYTES_PER_STATE * ref.max_states()))
    assign, score = {}, []
    for lo, hi in row_blocks(rows, block):
        a, s = ref.map_decode({v: m[lo:hi] for v, m in masks.items()})
        for v, x in a.items():
            assign.setdefault(v, []).append(x)
        score.append(s)
    return {"assign": {v: np.concatenate(x) for v, x in assign.items()},
            "score": np.concatenate(score)}


def compare(got, want, limits, masks, factors, values):
    """({check: reading}, rows failed) of the answers ``got`` against the
    reference's best scores ``want``; the reference also scores ``got``'s
    assignments in float64."""
    best = want["score"]
    feasible = np.isfinite(best)
    s = got["score"]
    bad = np.isnan(s) | (~feasible & (s >= INFEASIBLE))
    bad |= feasible & ~(s > INFEASIBLE)
    ok = feasible & ~bad
    with np.errstate(invalid="ignore"):
        score_err = np.where(ok, np.abs(s - best), 0.0)
    checks = {"score_err": float(score_err.max(initial=0.0))}
    failed = bad | (score_err > limits["score_err"])
    own = score_assignments(factors, values, got["assign"], masks)
    with np.errstate(invalid="ignore"):
        gap = np.where(feasible, best - own, 0.0)
    gap = np.where(np.isnan(gap), np.inf, gap)
    checks["assign_gap"] = float(gap.max(initial=0.0))
    failed |= gap > limits["assign_gap"]
    checks["bad_rows"] = int(bad.sum())
    return checks, int(failed.sum())


def judge(got, masks, factors, sizes, values, device, limits):
    return compare(got, reference(factors, sizes, values, masks, device),
                   limits, masks, factors, values)


def control(kind, factors, sizes, values, masks, device):
    """The control's answers for the rows of ``masks``: "reference_bf16" is
    the reference decoding with its log potentials, masks and sums in
    bfloat16."""
    if kind == "reference_bf16":
        return reference(factors, sizes, values, masks, device,
                         torch.bfloat16)
    raise ValueError(f"no control {kind!r} for MAP")
