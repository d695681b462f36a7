"""Compile phase: factor graph -> static propagation plan.

Counterpart of ``junctiontree_tpu/schedule.py``, copied because that package
imports JAX on import.  Everything here is host-side Python over interned
ints — no array math.  The resulting :class:`Plan` is a pure-data,
JSON-serializable artifact; both packages compile identical plans for the
same model (the Python compiler is the same code), and each package loads the
other's ``Plan.to_json()`` output.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Optional, Sequence

from .labels import LabelTable, intern_factors
from .triangulate import Triangulation, min_fill_triangulation
from .treebuild import JunctionTreeStructure, build_junction_tree


@dataclass
class Plan:
    """A compiled junction-tree inference plan (all vars interned ints)."""

    table: LabelTable
    factors: List[List[int]]            # factor ix -> var ids
    sizes: List[int]                    # var id -> cardinality
    tri: Triangulation
    tree: JunctionTreeStructure
    var_to_clique: List[int]            # var id -> clique where evidence mask lands
    # the elimination order that won: the heuristic asked for, or under
    # "auto" "min_fill", "bandwidth", "portfolio16" or "anneal"; None for a
    # plan loaded from JSON (not part of the JSON)
    order: Optional[str] = None

    @property
    def clique_vars(self) -> List[List[int]]:
        return self.tri.maxcliques

    @property
    def sep_vars(self) -> List[List[int]]:
        return self.tree.separators

    @property
    def num_vars(self) -> int:
        return len(self.sizes)

    def clique_shape(self, c: int) -> tuple:
        return tuple(self.sizes[v] for v in self.tri.maxcliques[c])

    def sep_shape(self, s: int) -> tuple:
        return tuple(self.sizes[v] for v in self.tree.separators[s])

    def factor_shape(self, f: int) -> tuple:
        return tuple(self.sizes[v] for v in self.factors[f])

    # ---- observability: compile stats (SURVEY.md §5 tracing row) ----
    def stats(self) -> Dict[str, Any]:
        # memoized: the plan is immutable after compile, and hot serving
        # paths (e.g. the cold-start gate in Engine.posterior_batch)
        # consult stats per call — the O(cliques x width) recompute is
        # pure waste there
        cached = getattr(self, "_stats_cache", None)
        if cached is not None:
            return dict(cached)
        clique_states = [
            int(_prod(self.sizes[v] for v in c)) for c in self.tri.maxcliques
        ]
        depth = 0
        d = {self.tree.root: 0}
        for c in self.tree.topo_order[1:]:
            d[c] = d[self.tree.parent[c]] + 1
            depth = max(depth, d[c])
        sep_states = [
            int(_prod(self.sizes[v] for v in s))
            for s in self.tree.separators
        ]
        out = {
            "num_vars": self.num_vars,
            "num_factors": len(self.factors),
            "num_cliques": self.tri.num_cliques,
            "num_separators": len(self.tree.separators),
            "treewidth": self.tri.treewidth,
            "max_clique_states": max(clique_states) if clique_states else 0,
            "total_clique_states": sum(clique_states),
            # batched messages live on separators: serving memory scales
            # with B x max_sep_states (see Engine.max_feasible_batch)
            "max_sep_states": max(sep_states) if sep_states else 0,
            "tree_depth": depth,
            "order": self.order,
        }
        object.__setattr__(self, "_stats_cache", out)
        return dict(out)

    # ---- checkpoint/resume of the compile artifact (SURVEY.md §5): the
    # reference keeps its compiled tree only in memory (junctiontree.py:
    # 277-294); here triangulation cost is paid once per model ----
    def to_json(self) -> str:
        return json.dumps(
            {
                "version": 1,
                "labels": [_encode_label(x) for x in self.table.labels],
                "factors": self.factors,
                "sizes": self.sizes,
                "maxcliques": self.tri.maxcliques,
                "factor_to_maxclique": self.tri.factor_to_maxclique,
                "elimination_order": self.tri.elimination_order,
                "fill_edges": [list(e) for e in self.tri.fill_edges],
                "treewidth": self.tri.treewidth,
                "separators": self.tree.separators,
                "edges": [list(e) for e in self.tree.edges],
                "root": self.tree.root,
                "var_to_clique": self.var_to_clique,
            }
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def _encode_label(x) -> list:
    if isinstance(x, str):
        return ["s", x]
    if isinstance(x, bool):
        return ["b", x]
    if isinstance(x, int):
        return ["i", x]
    if isinstance(x, float):
        return ["f", x]
    import base64
    import pickle

    return ["p", base64.b64encode(pickle.dumps(x)).decode("ascii")]


def _decode_label(t):
    tag, v = t
    if tag in ("s", "b", "i", "f"):
        return v
    import base64
    import pickle

    return pickle.loads(base64.b64decode(v))


def plan_from_json(js: str) -> Plan:
    """Inverse of Plan.to_json: rebuild the full compiled plan without
    re-running triangulation."""
    from .treebuild import build_junction_tree_from_edges

    d = json.loads(js)
    table = LabelTable()
    for t in d["labels"]:
        table.intern(_decode_label(t))
    tri = Triangulation(
        maxcliques=[list(c) for c in d["maxcliques"]],
        factor_to_maxclique=list(d["factor_to_maxclique"]),
        elimination_order=list(d["elimination_order"]),
        fill_edges=[tuple(e) for e in d["fill_edges"]],
        treewidth=d["treewidth"],
    )
    tree = build_junction_tree_from_edges(
        len(tri.maxcliques),
        [list(s) for s in d["separators"]],
        [tuple(e) for e in d["edges"]],
        d["root"],
    )
    return Plan(
        table=table,
        factors=[list(f) for f in d["factors"]],
        sizes=list(d["sizes"]),
        tri=tri,
        tree=tree,
        var_to_clique=list(d["var_to_clique"]),
    )


def load_plan(path: str) -> Plan:
    with open(path) as f:
        return plan_from_json(f.read())


def _prod(xs) -> int:
    p = 1
    for x in xs:
        p *= int(x)
    return p


def compile_plan(
    factors: Sequence[Sequence[Hashable]],
    sizes: Dict[Hashable, int],
    root: Optional[int] = None,
    backend: str = "auto",
    heuristic: str = "auto",
) -> Plan:
    """Full compile path: intern -> triangulate -> junction tree -> plan.

    Mirrors the reference stack ``create_junction_tree`` -> ``triangulate`` ->
    ``create_junction_tree`` (SURVEY.md §3.1) in one host-side call.

    backend: "auto" uses the native C++ compiler (``native/``, built with
    ``g++`` at first use) for min-fill on models of 512 variables or more
    when it is available, and the Python compiler otherwise; "native" /
    "python" force a path ("native" raises without ``g++``).  Both
    compilers give the same plan.

    heuristic: elimination-order heuristic — 'auto' (default: min_fill,
    auto-escalating when greedy min-fill lands a clique above
    ``config.DEFAULT.escalate_min_states`` — greedy min-fill is 2-6x over
    the optimal treewidth exactly on the models where it hurts most — to a
    randomized portfolio, then annealing while the plan stays above it,
    with a Cuthill-McKee bandwidth order as one more candidate, keeping the
    plan with the smaller largest clique, then total states;
    ``Plan.order`` and ``stats()["order"]`` name the winner, and the
    counter ``compile.escalations`` counts the compiles that escalate),
    'min_fill'
    (reference parity, no escalation), 'min_degree',
    'min_weight', 'portfolio[N]' (run all three plus N randomized restarts,
    keep the smallest total clique state space), or 'anneal[S]' (portfolio
    seed + simulated annealing over elimination orders for S seconds,
    default 2 — best quality, one-time compile cost; both ignore the native
    backend).

    Every phase is timed into ``utils.timing.TIMERS`` (keys
    ``compile.intern`` / ``compile.triangulate`` / ``compile.treebuild``)
    and the resulting plan is logged via ``log_compile_stats``."""
    from .utils.timing import TIMERS, log_compile_stats

    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    with TIMERS.phase("compile.intern"):
        table, int_factors, int_sizes = intern_factors(factors, sizes)
    if not int_factors:
        raise ValueError("need at least one factor")
    if root is None:
        root = 0

    escalate = heuristic == "auto"
    if escalate:
        heuristic = "min_fill"
    tri = None
    nat = None
    with TIMERS.phase("compile.triangulate"):
        if heuristic.startswith("anneal"):
            from .triangulate import anneal_triangulation

            suffix = heuristic[len("anneal"):]
            budget = float(suffix) if suffix else 2.0
            tri = anneal_triangulation(
                int_factors, int_sizes, time_budget_s=budget
            )
        elif heuristic.startswith("portfolio"):
            from .triangulate import portfolio_triangulation

            # "portfolio" = 3 greedy heuristics; "portfolioN" adds N
            # randomized min-fill restarts
            suffix = heuristic[len("portfolio"):]
            restarts = int(suffix) if suffix else 0
            tri = portfolio_triangulation(
                int_factors, int_sizes, random_restarts=restarts
            )
        use_native = tri is None and heuristic == "min_fill" and (
            backend == "native"
            or (backend == "auto" and len(int_sizes) >= 512)
        )
        if use_native:
            from . import native

            nat = native.native_compile(int_factors, int_sizes)
            if nat is None and backend == "native":
                raise RuntimeError(
                    "native compiler requested but unavailable (no g++?)"
                )
            if nat is not None:
                tri = Triangulation(
                    maxcliques=nat["maxcliques"],
                    factor_to_maxclique=nat["factor_to_maxclique"],
                    elimination_order=nat["elimination_order"],
                    fill_edges=nat["fill_edges"],
                    treewidth=nat["treewidth"],
                )
        if tri is None:
            tri = min_fill_triangulation(
                int_factors, int_sizes, heuristic=heuristic
            )
        order = heuristic
        if escalate:
            # auto-escalation: when greedy min-fill lands a clique above the
            # threshold, a randomized portfolio usually shrinks it by orders
            # of magnitude (hailfinder-class: 31M -> ~1M states), and
            # annealing recovers most of what is still above it; the
            # bandwidth sweep (milliseconds; on a lattice the optimal width)
            # is one more candidate beside them.  The better plan (largest
            # clique, then total states) wins, and a tie keeps the earlier
            from .config import DEFAULT as _CFG
            from .triangulate import (
                anneal_triangulation,
                bandwidth_triangulation,
                portfolio_triangulation,
                total_states,
            )

            def worst(t):
                return max(
                    _prod(int_sizes[v] for v in c) for c in t.maxcliques
                )

            def better(t2, t1):
                return (worst(t2), total_states(t2, int_sizes)) < (
                    worst(t1), total_states(t1, int_sizes)
                )

            if worst(tri) > _CFG.escalate_min_states:
                TIMERS.add("compile.escalations")
                tri2 = portfolio_triangulation(
                    int_factors, int_sizes, random_restarts=16
                )
                if better(tri2, tri):
                    tri, order, nat = tri2, "portfolio16", None
                if worst(tri) > _CFG.escalate_min_states:
                    # a fixed step budget (not wall clock), so the
                    # triangulation is deterministic across processes and
                    # packages
                    tri3 = anneal_triangulation(
                        int_factors, int_sizes, steps=2000
                    )
                    if better(tri3, tri):
                        tri, order, nat = tri3, "anneal", None
                tri4 = bandwidth_triangulation(int_factors, int_sizes)
                if better(tri4, tri):
                    tri, order, nat = tri4, "bandwidth", None
    with TIMERS.phase("compile.treebuild"):
        if nat is not None:
            from .treebuild import build_junction_tree_from_edges

            tree = build_junction_tree_from_edges(
                len(nat["maxcliques"]), nat["separators"], nat["edges"], root
            )
        else:
            tree = build_junction_tree(tri.maxcliques, int_sizes, root=root)

    # evidence landing site: smallest clique containing each var
    var_to_clique = [-1] * len(int_sizes)
    clique_states = [_prod(int_sizes[v] for v in c) for c in tri.maxcliques]
    for ci, c in enumerate(tri.maxcliques):
        for v in c:
            cur = var_to_clique[v]
            if cur < 0 or clique_states[ci] < clique_states[cur]:
                var_to_clique[v] = ci
    assert all(ci >= 0 for ci in var_to_clique)

    plan = Plan(
        table=table,
        factors=int_factors,
        sizes=int_sizes,
        tri=tri,
        tree=tree,
        var_to_clique=var_to_clique,
        order=order,
    )
    log_compile_stats(plan)
    return plan
