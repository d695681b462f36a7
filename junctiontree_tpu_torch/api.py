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

    def engine(
        self,
        semiring: str = "sum_product",
        device=None,
        dtype: Optional[torch.dtype] = None,
    ) -> Engine:
        """The engine for this tree on ``device`` (default CUDA device 0;
        ``"cpu"`` runs on the CPU) in ``dtype`` (default
        ``config.DEFAULT.storage_dtype``), one per combination."""
        if isinstance(semiring, Semiring):
            semiring = semiring.name
        if semiring not in SEMIRINGS:
            raise NotImplementedError(
                f"semiring {semiring!r} is not ported yet (ROADMAP.md)"
            )
        device = resolve_device(device)
        key = (semiring, str(device), dtype)
        if key not in self._engines:
            self._engines[key] = Engine(
                self._plan, SEMIRINGS[semiring], device=device, dtype=dtype
            )
        return self._engines[key]

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
