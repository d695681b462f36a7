"""Carry a serving state across from the JAX package.

The JAX package's compiled ``Plan.to_json()`` and its engine's evaluated
clique potentials (numpy arrays, one per clique in the plan's axis order)
are all an engine needs: with them the port serves the same tree with the
same numbers, without re-triangulating or re-evaluating factors.  This is
the port's counterpart of carrying trained weights over.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .executor import Engine
from .schedule import plan_from_json


def engine_from_numpy(
    plan_json: str,
    clique_pots: Sequence[np.ndarray],
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> Engine:
    """An :class:`Engine` on ``device`` in ``dtype`` for the plan serialized
    in ``plan_json``, serving the given clique potentials."""
    plan = plan_from_json(plan_json)
    return Engine(plan, device=device, dtype=dtype).set_clique_potentials(
        [np.asarray(p) for p in clique_pots]
    )
