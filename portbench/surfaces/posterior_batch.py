"""``Engine.posterior_batch`` on a sum-product engine: posteriors and logZ.

Compared with the float64 reference on a sample of rows: the largest
absolute error of a posterior probability and of logZ over the rows with
possible evidence, and the rows that break the rule for impossible
evidence (all posteriors 0 and logZ = -inf) or hold a NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import Reference, row_blocks

# bytes of float64 reference state per row and clique state that a block
# of rows may take (operands, their outer product, einsum's copies)
_REF_BYTES_PER_STATE = 32
_REF_BUDGET = 8 << 30


def batches(pool):
    """The call's inputs: the pool's linear 0/1 masks as they are."""
    return pool


def engine(jt, factors, sizes, values, device, cfg):
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine("sum_product", device=device,
                      dtype=getattr(torch, cfg["dtype"]))
    return eng.set_potentials(values)


def call(eng, batch):
    return eng.posterior_batch(batch)


def take(eng, out, rows):
    """The answers of ``rows`` on the host in float64."""
    posts, logz = out
    idx = torch.as_tensor(rows, device=logz.device)
    label = eng.plan.table.label_of
    return {"post": {label(v): p.index_select(0, idx).double().cpu().numpy()
                     for v, p in enumerate(posts)},
            "logz": logz.index_select(0, idx).double().cpu().numpy()}


def reference(factors, sizes, values, masks, device, dtype=torch.float64,
              tf32=False):
    """The reference's answers for every row of ``masks``, in blocks."""
    ref = Reference(factors, sizes, values, device, dtype, tf32=tf32)
    rows = len(next(iter(masks.values())))
    block = max(1, _REF_BUDGET // (_REF_BYTES_PER_STATE * ref.max_states()))
    post, logz = {}, []
    for lo, hi in row_blocks(rows, block):
        p, z = ref.posteriors({v: m[lo:hi] for v, m in masks.items()})
        for v, x in p.items():
            post.setdefault(v, []).append(x)
        logz.append(z)
    return {"post": {v: np.concatenate(x) for v, x in post.items()},
            "logz": np.concatenate(logz)}


def compare(got, want, limits, masks=None, factors=None, values=None):
    """({check: reading}, rows failed) of the answers ``got`` against the
    reference's ``want`` (which alone the comparison needs)."""
    feasible = np.isfinite(want["logz"])
    rows = len(feasible)
    post_err = np.zeros(rows)
    bad = np.zeros(rows, dtype=bool)
    for v, ref in want["post"].items():
        g = got["post"][v]
        err = np.abs(g - ref).max(axis=1)
        post_err = np.maximum(post_err, np.where(np.isnan(err), np.inf, err))
        bad |= np.isnan(g).any(axis=1)
        bad |= ~feasible & (g != 0).any(axis=1)
    z = got["logz"]
    bad |= np.isnan(z)
    bad |= ~feasible & ~np.isneginf(z)
    bad |= feasible & ~np.isfinite(z)
    with np.errstate(invalid="ignore"):
        logz_err = np.where(feasible & np.isfinite(z),
                            np.abs(z - want["logz"]), 0.0)
    post_err = np.where(feasible, post_err, 0.0)
    checks = {"post_err": float(post_err.max(initial=0.0)),
              "logz_err": float(logz_err.max(initial=0.0)),
              "bad_rows": int(bad.sum())}
    failed = (bad | (post_err > limits["post_err"])
              | (logz_err > limits["logz_err"]))
    return checks, int(failed.sum())


def judge(got, masks, factors, sizes, values, device, limits):
    return compare(got, reference(factors, sizes, values, masks, device),
                   limits)


def control(kind, factors, sizes, values, masks, device):
    """The control's answers for the rows of ``masks``: "reference_tf32" is
    the reference in float32 with every product's operands in TF32."""
    if kind == "reference_tf32":
        return reference(factors, sizes, values, masks, device,
                         torch.float32, tf32=True)
    raise ValueError(f"no control {kind!r} for posteriors")
