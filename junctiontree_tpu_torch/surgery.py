"""Incremental tree surgery: composable edits to trees and compiled plans
(a copy of ``junctiontree_tpu/surgery.py``, host code only, on this
package's ``labels``, ``schedule``, ``treebuild`` and ``triangulate``).

Two levels:

- **Nested-list functions** ``change_root`` / ``insert_sepset`` /
  ``merge_trees`` on the ``[clique_ix, (sep_ix, subtree), ...]`` format that
  ``JunctionTree.tree`` returns.  Edge-list based (flatten -> re-root ->
  rebuild), so deep chains do not multiply Python frames per level.

- **Plan-level incremental edits** on the compiled :class:`~.schedule.Plan`,
  so that the (potentially expensive) triangulation is NOT re-run when the
  edit provably preserves the junction tree:

  * :func:`add_factor`: a new factor whose scope is covered by an existing
    clique attaches there in O(cliques) -- the tree, separators and every
    program shape are unchanged.  Uncovered scopes fall back to a full
    recompile (opt-out via ``allow_rebuild=False``).
  * :func:`remove_factor`: always O(1) -- deleting a factor never
    invalidates the running-intersection property.
  * :func:`merge_plans`: two compiled plans over disjoint variables become
    one forest plan joined by an empty separator, with zero
    retriangulation; one engine then serves both models and their logZs add.

``Engine.multiply_factor`` is the serving-side face of a covered
:func:`add_factor`.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from .labels import LabelTable
from .schedule import Plan, compile_plan, _prod
from .treebuild import build_junction_tree_from_edges
from .triangulate import Triangulation


# ---------------------------------------------------------------------------
# Nested-list tree surgery
# ---------------------------------------------------------------------------

def _nested_to_edges(tree: list) -> Tuple[List[int], List[Tuple[int, int, int]]]:
    """Flatten a nested tree to (node ids preorder, (parent, child, sep) edges)."""
    nodes: List[int] = []
    edges: List[Tuple[int, int, int]] = []
    stack = [tree]
    while stack:
        node = stack.pop()
        nodes.append(node[0])
        for sep, sub in node[1:]:
            edges.append((node[0], sub[0], sep))
            stack.append(sub)
    return nodes, edges


def _edges_to_nested(
    root: int, nodes: Sequence[int], edges: Sequence[Tuple[int, int, int]]
) -> list:
    adj: Dict[int, List[Tuple[int, int]]] = {c: [] for c in nodes}
    for a, b, s in edges:
        adj[a].append((b, s))
        adj[b].append((a, s))
    out: Dict[int, list] = {c: [c] for c in nodes}
    # BFS orientation from the new root, then attach children to parents
    order = [root]
    parent: Dict[int, Optional[int]] = {root: None}
    head = 0
    while head < len(order):
        c = order[head]
        head += 1
        for nxt, s in adj[c]:
            if nxt not in parent:
                parent[nxt] = c
                out[c].append((s, out[nxt]))
                order.append(nxt)
    return out[root]


def change_root(tree: list, clique_ix: int) -> list:
    """Re-root a nested tree at ``clique_ix``: returns ``tree`` unchanged if
    already rooted there, ``[]`` if the clique is absent."""
    if tree[0] == clique_ix:
        return tree
    nodes, edges = _nested_to_edges(tree)
    if clique_ix not in nodes:
        return []
    return _edges_to_nested(clique_ix, nodes, edges)


def insert_sepset(tree: list, clique_ix: int, sepset_group: tuple) -> list:
    """Insert ``(sep_ix, subtree)`` as a child of ``clique_ix`` (pure:
    returns a new tree)."""
    out: list = [tree[0]]
    for sep, sub in tree[1:]:
        out.append((sep, insert_sepset(sub, clique_ix, sepset_group)))
    if tree[0] == clique_ix:
        out.append((sepset_group[0], sepset_group[1]))
    return out


def merge_trees(
    tree1: list, clique1_ix: int, tree2: list, clique2_ix: int, sepset_ix: int
) -> list:
    """Join two nested trees through a new separator: ``tree2`` is re-rooted
    at ``clique2_ix`` and spliced under ``clique1_ix`` of ``tree1``."""
    return insert_sepset(
        tree1, clique1_ix, (sepset_ix, change_root(tree2, clique2_ix))
    )


# ---------------------------------------------------------------------------
# Plan-level incremental edits
# ---------------------------------------------------------------------------

def add_factor(
    plan: Plan,
    scope: Sequence[Hashable],
    sizes: Optional[Dict[Hashable, int]] = None,
    allow_rebuild: bool = True,
    heuristic: str = "auto",
) -> Tuple[Plan, bool]:
    """Add a factor to a compiled plan.

    Returns ``(new_plan, covered)``.  When every variable of ``scope``
    already lies inside one existing clique (``covered=True``), the factor is
    assigned to the smallest such clique and NOTHING else changes — no
    retriangulation, identical tree/separators, so every serving program
    keeps its shapes.  Otherwise (``covered=False``) the whole model
    is recompiled from scratch; ``sizes`` must then supply cardinalities for
    any variables new to the model.  ``allow_rebuild=False`` raises instead
    of rebuilding (for callers that must keep the compiled artifact stable).
    """
    scope = list(scope)
    if len(set(scope)) != len(scope):
        raise ValueError("factor %r contains a repeated variable" % (scope,))
    known = all(v in plan.table for v in scope)
    if known:
        order = [plan.table.id_of(v) for v in scope]
        idset = set(order)
        if not idset:
            # empty-scope (scalar) factor: folds into the root clique at
            # evaluate time (factor_to_maxclique == -1, triangulate.py:33)
            ci, covered = -1, True
        else:
            ci, ci_states = -1, None
            for c, cv in enumerate(plan.tri.maxcliques):
                if idset <= set(cv):
                    states = _prod(plan.sizes[v] for v in cv)
                    if ci_states is None or states < ci_states:
                        ci, ci_states = c, states
            covered = ci >= 0
        if covered:
            tri = Triangulation(
                maxcliques=[list(c) for c in plan.tri.maxcliques],
                factor_to_maxclique=list(plan.tri.factor_to_maxclique) + [ci],
                elimination_order=list(plan.tri.elimination_order),
                fill_edges=list(plan.tri.fill_edges),
                treewidth=plan.tri.treewidth,
            )
            new = Plan(
                table=plan.table,
                factors=[list(f) for f in plan.factors] + [order],
                sizes=list(plan.sizes),
                tri=tri,
                tree=plan.tree,
                var_to_clique=list(plan.var_to_clique),
            )
            return new, True
    if not allow_rebuild:
        raise ValueError(
            "factor %r is not covered by any existing clique and "
            "allow_rebuild=False" % (scope,)
        )
    label_factors = [plan.table.labels_of(f) for f in plan.factors]
    label_sizes: Dict[Hashable, int] = {
        plan.table.label_of(v): plan.sizes[v] for v in range(plan.num_vars)
    }
    for v in scope:
        if v not in label_sizes:
            if sizes is None or v not in sizes:
                raise KeyError(
                    "new variable %r needs a cardinality via sizes" % (v,)
                )
            label_sizes[v] = int(sizes[v])
    new = compile_plan(
        label_factors + [scope], label_sizes, heuristic=heuristic
    )
    return new, False


def remove_factor(plan: Plan, factor_ix: int) -> Plan:
    """Remove a factor from a compiled plan — always O(1), never
    retriangulates: deleting a factor can only *loosen* the model, so the
    existing tree remains a valid junction tree for the remaining factors
    (possibly with slack cliques; rebuild when compactness matters).
    Factor indices above ``factor_ix`` shift down by one, matching how a
    ``propagate`` values list would shrink."""
    n = len(plan.factors)
    if not (0 <= factor_ix < n):
        raise IndexError("factor index %d out of range [0, %d)" % (factor_ix, n))
    if n == 1:
        raise ValueError("cannot remove the last factor of a plan")
    keep = [i for i in range(n) if i != factor_ix]
    tri = Triangulation(
        maxcliques=[list(c) for c in plan.tri.maxcliques],
        factor_to_maxclique=[plan.tri.factor_to_maxclique[i] for i in keep],
        elimination_order=list(plan.tri.elimination_order),
        fill_edges=list(plan.tri.fill_edges),
        treewidth=plan.tri.treewidth,
    )
    return Plan(
        table=plan.table,
        factors=[list(plan.factors[i]) for i in keep],
        sizes=list(plan.sizes),
        tri=tri,
        tree=plan.tree,
        var_to_clique=list(plan.var_to_clique),
    )


def merge_plans(p1: Plan, p2: Plan, on_shared: str = "error") -> Plan:
    """Merge two compiled plans into one.

    Disjoint variable sets (the fast path): one forest plan, trees joined by
    an empty separator — no retriangulation.  Factor order is
    ``p1.factors ++ p2.factors``; logZ of the merged model is the sum of the
    two models' logZs, and every marginal is unchanged (tested in
    tests/test_torch_surgery.py).

    Overlapping variable sets genuinely couple the models, so no junction
    tree of the union can be assembled from the two old trees in general;
    ``on_shared="rebuild"`` recompiles the concatenated factor list (shared
    labels must agree on cardinality), ``"error"`` (default) raises."""
    shared = set(p1.table.labels) & set(p2.table.labels)
    if shared:
        if on_shared != "rebuild":
            raise ValueError(
                "merge_plans requires disjoint variable sets unless "
                "on_shared='rebuild'; shared: %r"
                % (sorted(shared, key=repr)[:5],)
            )
        sizes: Dict[Hashable, int] = {
            p1.table.label_of(v): p1.sizes[v] for v in range(p1.num_vars)
        }
        for v in range(p2.num_vars):
            lab = p2.table.label_of(v)
            if lab in sizes and sizes[lab] != p2.sizes[v]:
                raise ValueError(
                    "shared variable %r has cardinality %d in p1 but %d "
                    "in p2" % (lab, sizes[lab], p2.sizes[v])
                )
            sizes.setdefault(lab, p2.sizes[v])
        return compile_plan(
            [p1.table.labels_of(f) for f in p1.factors]
            + [p2.table.labels_of(f) for f in p2.factors],
            sizes,
        )
    table = LabelTable()
    for x in p1.table.labels:
        table.intern(x)
    voff = len(table)
    for x in p2.table.labels:
        table.intern(x)
    nc1, ns1 = p1.tri.num_cliques, len(p1.tree.separators)

    def shift_vars(vss, off):
        return [[v + off for v in vs] for vs in vss]

    tri = Triangulation(
        maxcliques=[list(c) for c in p1.tri.maxcliques]
        + shift_vars(p2.tri.maxcliques, voff),
        factor_to_maxclique=list(p1.tri.factor_to_maxclique)
        + [c + nc1 if c >= 0 else -1 for c in p2.tri.factor_to_maxclique],
        elimination_order=list(p1.tri.elimination_order)
        + [v + voff for v in p2.tri.elimination_order],
        fill_edges=list(p1.tri.fill_edges)
        + [(a + voff, b + voff) for a, b in p2.tri.fill_edges],
        treewidth=max(p1.tri.treewidth, p2.tri.treewidth),
    )
    separators = (
        [list(s) for s in p1.tree.separators]
        + shift_vars(p2.tree.separators, voff)
        + [[]]  # the joining empty separator
    )
    edges = (
        list(p1.tree.edges)
        + [(a + nc1, b + nc1, s + ns1) for a, b, s in p2.tree.edges]
        + [(p1.tree.root, p2.tree.root + nc1, len(separators) - 1)]
    )
    tree = build_junction_tree_from_edges(
        nc1 + p2.tri.num_cliques, separators, edges, p1.tree.root
    )
    return Plan(
        table=table,
        factors=[list(f) for f in p1.factors]
        + shift_vars(p2.factors, voff),
        sizes=list(p1.sizes) + list(p2.sizes),
        tri=tri,
        tree=tree,
        var_to_clique=list(p1.var_to_clique)
        + [c + nc1 for c in p2.var_to_clique],
    )
