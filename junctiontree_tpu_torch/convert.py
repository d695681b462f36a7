"""Carry a serving state across from the JAX package.

The JAX package's compiled ``Plan.to_json()`` and its engine's evaluated
clique potentials (numpy arrays, one per clique in the plan's axis order,
in the engine's semiring space) are all an engine needs: with them the port
serves the same tree with the same numbers, without re-triangulating or
re-evaluating factors.  This is the port's counterpart of carrying trained
weights over.  The stacked forms that the chain and level-fused programs
read are functions of the same arrays.  A max-product engine takes its
potentials in log space (``semiring=MAX_PRODUCT``), as the JAX engine's MAP
sibling holds them; an incremental session takes its cached collect
messages and their rescale offsets (:func:`session_from_numpy`).

The learners and the solvers beside the ``Engine`` start from host arrays
too: per-factor log-potentials (:func:`thetas_from_numpy`, and packed for
the chain learner by :func:`chain_params_from_numpy`), and the factor
lists, values and settings that a ``CutsetEngine`` or ``LoopyEngine`` of the
JAX package holds as numpy (:func:`cutset_engine_from_numpy`,
:func:`loopy_engine_from_numpy`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .approx import LoopyEngine
from .cutset import CutsetEngine
from .executor import Engine, resolve_device
from .incremental import IncrementalSession
from .fused import build_fused_schedule, stack_group_potentials
from .learn_chain import _ChainParams
from .ops.semirings import SUM_PRODUCT, Semiring
from .scan_executor import ChainLayout, stack_chain_potentials
from .schedule import plan_from_json


def engine_from_numpy(
    plan_json: str,
    clique_pots: Sequence[np.ndarray],
    device=None,
    dtype: Optional[torch.dtype] = None,
    semiring: Semiring = SUM_PRODUCT,
) -> Engine:
    """An :class:`Engine` on ``device`` (default CUDA device 0; ``"cpu"``
    runs on the CPU) in ``dtype`` and ``semiring`` for the plan serialized
    in ``plan_json``, serving the given clique potentials (which are in
    that semiring's space)."""
    plan = plan_from_json(plan_json)
    return Engine(
        plan, semiring, device=device, dtype=dtype
    ).set_clique_potentials([np.asarray(p) for p in clique_pots])


def chain_stack_from_numpy(
    plan_json: str, clique_pots: Sequence[np.ndarray]
) -> np.ndarray:
    """The [m, K, K] transition stack the chain program reads, from the
    clique potentials of a uniform-chain plan."""
    layout = ChainLayout.detect(plan_from_json(plan_json))
    if layout is None:
        raise ValueError("the plan is not a uniform chain")
    return stack_chain_potentials(layout, clique_pots)


def fused_stacks_from_numpy(
    plan_json: str, clique_pots: Sequence[np.ndarray]
) -> List[List[np.ndarray]]:
    """The per-level, per-group [G, *shape] stacks the level-fused program
    reads, from the clique potentials."""
    sched, _ = build_fused_schedule(plan_from_json(plan_json))
    return stack_group_potentials(sched, clique_pots)


def session_from_numpy(
    engine: Engine, mask_batch, ups: Sequence, offs: Sequence
) -> IncrementalSession:
    """An :class:`IncrementalSession` on ``engine`` under the base evidence
    ``mask_batch`` whose cached collect state is given, not computed:
    ``ups[c]`` is clique c's rescaled upward message (``None`` at the root),
    ``offs[c]`` the log of its rescale factor, as numpy arrays in the plan's
    axis order (what the JAX session holds in ``_ups`` and ``_offs``)."""
    return IncrementalSession(
        engine, mask_batch,
        cached=(
            [None if u is None else engine._place(np.array(u)) for u in ups],
            [None if o is None else engine._place(np.array(o)) for o in offs],
        ),
    )


def thetas_from_numpy(
    thetas: Sequence[np.ndarray], device=None,
    dtype: torch.dtype = torch.float32,
) -> List[torch.Tensor]:
    """Per-factor log-potentials as tensors on ``device`` (default CUDA
    device 0) in ``dtype``: what ``learn.log_likelihood`` and
    ``learn.marginal_log_likelihood`` take."""
    device = resolve_device(device)
    return [
        torch.as_tensor(np.asarray(t), dtype=dtype, device=device) for t in thetas
    ]


def chain_params_from_numpy(
    plan_json: str, thetas: Sequence[np.ndarray], device=None,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The chain learner's packed parameter groups (``pair`` [n, K, K],
    ``head`` and ``tail`` [n, K]) on ``device``, from per-factor
    log-potentials of a uniform-chain plan."""
    plan = plan_from_json(plan_json)
    layout = ChainLayout.detect(plan)
    if layout is None:
        raise ValueError("the plan is not a uniform chain")
    return _ChainParams(plan, layout).pack(thetas, resolve_device(device), dtype)


def cutset_engine_from_numpy(
    factors, sizes, values: Sequence[np.ndarray], cutset, device=None,
    dtype: torch.dtype = torch.float32, **settings,
) -> CutsetEngine:
    """A :class:`CutsetEngine` on ``device`` conditioning on the given
    ``cutset`` (the one another engine chose: nothing is searched again);
    ``settings`` are the constructor's (``state_chunk``,
    ``chunk_budget_bytes``)."""
    return CutsetEngine(
        factors, sizes, [np.asarray(v) for v in values], cutset=list(cutset),
        device=device, dtype=dtype, **settings,
    )


def loopy_engine_from_numpy(
    factors, sizes, values: Sequence[np.ndarray], device=None, **settings,
) -> LoopyEngine:
    """A :class:`LoopyEngine` on ``device`` serving the given factor values;
    ``settings`` are the constructor's (``damping``, ``max_iters``, ``tol``,
    ``chunk_iters``)."""
    return LoopyEngine(
        factors, sizes, [np.asarray(v) for v in values], device=device,
        **settings,
    )
