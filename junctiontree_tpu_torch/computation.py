"""Compatibility facade with the reference's ``junctiontree.computation``
module surface (counterpart of ``junctiontree_tpu/computation.py``):

  reference               ->  here
  -------------------------------------------------------------
  compute_beliefs          -> compute_beliefs (static schedule, no recursion)
  apply_evidence           -> evidence.apply_evidence (no [[array]] quirk)
  sum_product (module var) -> ops.semirings.SUM_PRODUCT

``compute_beliefs`` takes the compiled Plan plus per-clique potentials and
returns consistent clique and separator beliefs, the role of the
reference's two-pass recursion."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .evidence import apply_evidence  # noqa: F401
from .executor import propagate_cliques, resolve_device
from .ops.semirings import SUM_PRODUCT, Semiring
from .schedule import Plan

sum_product = SUM_PRODUCT  # the reference's module singleton


def compute_beliefs(
    plan: Plan,
    clique_potentials: Sequence[np.ndarray],
    dl: Semiring = SUM_PRODUCT,
    device=None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Two-pass belief propagation over the compiled plan, on ``device``
    (default CUDA device 0) in the potentials' dtype.

    Returns (clique_beliefs, separator_beliefs): each entry the
    unnormalized joint marginal over that node's variables (the reference's
    post-propagation beliefs, split in two lists instead of one
    clique ++ separator list)."""
    device = resolve_device(device)
    pots = [torch.as_tensor(np.asarray(p), device=device) for p in clique_potentials]
    cb, sb = propagate_cliques(plan, pots, dl)
    return [x.cpu().numpy() for x in cb], [x.cpu().numpy() for x in sb]
