"""User API (counterpart of ``junctiontree_tpu/api.py``).

``create_junction_tree(factors, sizes)`` and the FactorGraph -> CliqueGraph
-> JunctionTree chain, with ``JunctionTree.propagate(values)`` returning a
list of unnormalized factor marginals with the same length and shapes as
the inputs, and ``JunctionTree.engine(device=..., dtype=...)`` exposing the
serving path on a torch device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .executor import Engine, resolve_device
from .ops.semirings import SEMIRINGS, Semiring
from .schedule import Plan, compile_plan


def create_junction_tree(factors, sizes) -> "JunctionTree":
    """Build a junction tree for the given factor graph.

    factors: list of lists of hashable variable labels (one list per factor).
    sizes:   dict label -> cardinality."""
    for f in factors:
        if not isinstance(f, (list, tuple)):
            raise TypeError("factors must be given as lists of variables")
    return FactorGraph(factors=factors, sizes=sizes).triangulate().create_junction_tree()


class FactorGraph:
    """A factor graph: factor variable-lists + variable sizes."""

    def __init__(self, factors, sizes):
        self.factors = [list(f) for f in factors]
        self.sizes = dict(sizes)

    def triangulate(self) -> "CliqueGraph":
        return CliqueGraph(self, compile_plan(self.factors, self.sizes))


class CliqueGraph:
    """Triangulated graph: maximal cliques + factor assignment."""

    def __init__(self, factor_graph: FactorGraph, plan: Plan):
        self.factor_graph = factor_graph
        self._plan = plan

    @property
    def maxcliques(self) -> List[list]:
        return [self._plan.table.labels_of(c) for c in self._plan.tri.maxcliques]

    @property
    def factor_to_maxclique(self) -> List[int]:
        return list(self._plan.tri.factor_to_maxclique)

    def create_junction_tree(self) -> "JunctionTree":
        return JunctionTree(self, self._plan)


class JunctionTree:
    """A compiled junction tree.

    ``tree`` is the reference-format recursive list
    ``[clique_ix, (sep_ix, subtree), ...]`` with separator ids offset by the
    clique count, ``separators`` the separator variable lists in label
    space."""

    def __init__(self, clique_graph: CliqueGraph, plan: Plan):
        self.clique_tree = clique_graph
        self._plan = plan
        self._engines: Dict[tuple, Engine] = {}

    @property
    def tree(self) -> list:
        return self._plan.tree.to_nested()

    @property
    def separators(self) -> List[list]:
        return [self._plan.table.labels_of(s) for s in self._plan.tree.separators]

    @property
    def maxcliques(self) -> List[list]:
        return self.clique_tree.maxcliques

    @property
    def plan(self) -> Plan:
        return self._plan

    def stats(self) -> dict:
        return self._plan.stats()

    # ---- incremental surgery on the compiled plan (see surgery.py) ----
    def _rewrap(self, plan: Plan) -> "JunctionTree":
        fg = FactorGraph(
            [plan.table.labels_of(f) for f in plan.factors],
            {plan.table.label_of(v): plan.sizes[v] for v in range(plan.num_vars)},
        )
        return JunctionTree(CliqueGraph(fg, plan), plan)

    def add_factor(self, scope, sizes: Optional[Dict] = None) -> "JunctionTree":
        """New JunctionTree with one more factor (appended last in the
        ``propagate`` values order).  Scopes covered by an existing clique
        attach without retriangulation; anything else recompiles (new
        variables need ``sizes``)."""
        from .surgery import add_factor as _add

        plan, _ = _add(self._plan, scope, sizes=sizes)
        return self._rewrap(plan)

    def remove_factor(self, factor_ix: int) -> "JunctionTree":
        """New JunctionTree without factor ``factor_ix`` (always O(1); the
        tree is reused, see ``surgery.remove_factor``)."""
        from .surgery import remove_factor as _rm

        return self._rewrap(_rm(self._plan, factor_ix))

    def merge(self, other: "JunctionTree") -> "JunctionTree":
        """Merge with another compiled tree over disjoint variables into one
        forest (joined by an empty separator; factor order = self ++ other).
        No retriangulation, see ``surgery.merge_plans``."""
        from .surgery import merge_plans

        return self._rewrap(merge_plans(self._plan, other._plan))

    def engine(
        self,
        semiring: str = "sum_product",
        device=None,
        dtype: Optional[torch.dtype] = None,
    ) -> Engine:
        """The engine for this tree on ``device`` (default CUDA device 0;
        ``"cpu"`` runs on the CPU) in ``dtype`` (default
        ``config.DEFAULT.storage_dtype``; see :class:`Engine`), one per
        combination.  ``semiring``: "sum_product", "log_sum_exp" or
        "max_product", or the Semiring itself."""
        if isinstance(semiring, Semiring):
            semiring = semiring.name
        if semiring not in SEMIRINGS:
            raise ValueError(
                f"unknown semiring {semiring!r}; one of {sorted(SEMIRINGS)}"
            )
        device = resolve_device(device)
        key = (semiring, str(device), dtype)
        if key not in self._engines:
            self._engines[key] = Engine(
                self._plan, SEMIRINGS[semiring], device=device, dtype=dtype
            )
        return self._engines[key]

    def marginal_map(
        self,
        values: Sequence[np.ndarray],
        map_vars: Sequence,
        evidence: Optional[Dict] = None,
        device=None,
    ):
        """Exact Marginal MAP over ``map_vars`` (max over them, sum over
        the rest) given hard evidence, on ``device`` (default CUDA device
        0).  Builds a dedicated constrained (sum-before-max) solver: MMAP is
        not computable on this tree's free elimination order; see
        ``mmap.MarginalMapSolver`` for serving.

        Returns ({map var label: state}, log MMAP value)."""
        from .mmap import MarginalMapSolver

        plan = self._plan
        solver = MarginalMapSolver(
            [plan.table.labels_of(f) for f in plan.factors],
            {plan.table.label_of(v): plan.sizes[v]
             for v in range(plan.num_vars)},
            map_vars,
            device=device,
        )
        return solver.set_potentials(values).query(evidence)

    def propagate(
        self,
        values: Sequence[np.ndarray],
        semiring: str = "sum_product",
        device=None,
    ) -> List[np.ndarray]:
        """Full Hugin propagation: factor values in, unnormalized factor
        marginals out — same length and shapes as the input list (computed
        in float64 on ``device``, default CUDA device 0)."""
        return self.engine(
            semiring, device=device, dtype=torch.float64
        ).propagate(values)
