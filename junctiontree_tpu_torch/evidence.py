"""Evidence conditioning (counterpart of ``junctiontree_tpu/evidence.py``).

Two mechanisms:

1. ``apply_evidence`` / ``shrink_sizes``: shape-changing, reference-style
   evidence.  Each factor's observed axes are sliced to the observed state,
   and the sizes dict gives observed variables size 1.

2. Masks: evidence as a per-variable mask in semiring space, whose entries
   inconsistent with the observation are the semiring zero.  ``batch_masks``
   and ``batch_masks_sparse`` build the ``[B, size_v]`` numpy mask batches
   that ``Engine.posterior_batch`` serves.

Everything here is numpy, so the same arrays feed both packages in the
parity tests.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Sequence

import numpy as np

from .ops.semirings import SUM_PRODUCT, Semiring
from .schedule import Plan


def apply_evidence(
    values: Sequence[np.ndarray],
    factor_vars: Sequence[Sequence[Hashable]],
    evidence: Dict[Hashable, int],
) -> List[np.ndarray]:
    """Slice each factor's observed axes down to the observed state.

    Shape-changing (reference-style) evidence: returns new value arrays where
    every axis belonging to an observed variable has length 1."""
    out: List[np.ndarray] = []
    for val, fvars in zip(values, factor_vars):
        v = np.asarray(val)
        if v.ndim == 0:
            out.append(v)
            continue
        index = tuple(
            slice(evidence[x], evidence[x] + 1) if x in evidence else slice(None)
            for x in fvars
        )
        out.append(v[index])
    return out


def shrink_sizes(
    sizes: Dict[Hashable, int], evidence: Dict[Hashable, int]
) -> Dict[Hashable, int]:
    """Sizes dict for the sliced factor graph (observed vars -> size 1)."""
    return {k: (1 if k in evidence else s) for k, s in sizes.items()}


def batch_masks(
    plan: Plan,
    evidence_batch: Sequence[Dict[Hashable, int]],
    semiring: Semiring = SUM_PRODUCT,
) -> List[np.ndarray]:
    """Stack a batch of evidence dicts into per-variable mask arrays.

    Returns one [B, size_v] array per variable id (semiring space), ready for
    ``Engine.posterior_batch``."""
    B = len(evidence_batch)
    zero = -np.inf if semiring.is_log else 0.0
    masks = [
        np.full((B, s), semiring.one, dtype=np.float32) for s in plan.sizes
    ]
    for b, ev in enumerate(evidence_batch):
        for label, state in ev.items():
            v = plan.table.id_of(label)
            masks[v][b, :] = zero
            masks[v][b, int(state)] = semiring.one
    return masks


def batch_masks_sparse(
    plan: Plan,
    evidence_batch: Sequence[Dict[Hashable, int]],
    semiring: Semiring = SUM_PRODUCT,
) -> Dict[Hashable, np.ndarray]:
    """Like ``batch_masks`` but returns masks only for variables observed
    somewhere in the batch: {label: [B, size_v]}.  Rows where a variable is
    unobserved get all-ones.  Feeding this to ``Engine.posterior_batch`` keeps
    evidence-free parts of the junction tree unbatched."""
    B = len(evidence_batch)
    zero = -np.inf if semiring.is_log else 0.0
    labels = sorted({k for ev in evidence_batch for k in ev}, key=repr)
    out: Dict[Hashable, np.ndarray] = {}
    for label in labels:
        v = plan.table.id_of(label)
        m = np.full((B, plan.sizes[v]), semiring.one, dtype=np.float32)
        for b, ev in enumerate(evidence_batch):
            if label in ev:
                m[b, :] = zero
                m[b, int(ev[label])] = semiring.one
        out[label] = m
    return out


def random_evidence_batch(
    plan: Plan,
    batch_size: int,
    observed_labels: Sequence[Hashable],
    seed: int = 0,
) -> List[Dict[Hashable, int]]:
    """Uniformly random evidence over the given variables (bench/test helper)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch_size):
        ev = {}
        for label in observed_labels:
            v = plan.table.id_of(label)
            ev[label] = int(rng.integers(plan.sizes[v]))
        out.append(ev)
    return out
