"""Junction-tree construction over maximal cliques (host-side compile phase).

Behavioral equivalent of the reference's ``construct_junction_tree``
(reference construction.py:522-578): consider every clique
pair's intersection as a candidate separator, pick separators by Jensen's
criterion — largest separator cardinality ("mass") first, then smallest sum of
the two cliques' state-space weights (construction.py:581-601) — and join with
a Kruskal spanning-forest sweep.  Empty separators are valid so disconnected
components end up in one tree (construction.py:530).

Differences by design: union-find instead of the reference's recursive
``find_subtree`` forest scan (construction.py:604-621), explicit sort key
(|sep| desc, weight asc, pair index asc) instead of a float ``1/(|sep|+0.001)``
heap key, and the result is exposed both as flat parent/children arrays (what
the compiled executor consumes) and as the reference's recursive
``[clique_ix, (sep_ix, subtree), ...]`` list (API parity; reference
README.md:43-70)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple


class _UnionFind:
    def __init__(self, n: int) -> None:
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[rb] = ra
        return True


@dataclass
class JunctionTreeStructure:
    """A rooted junction tree over ``num_cliques`` cliques.

    Separator ids index ``separators`` and, in the reference-style nested
    tree, are offset by ``num_cliques`` (node_list = maxcliques ++ separators,
    reference junctiontree.py:317-318)."""

    num_cliques: int
    separators: List[List[int]]                # sep ix -> sorted var ids
    edges: List[Tuple[int, int, int]]          # (clique_a, clique_b, sep_ix)
    root: int
    parent: List[int]                          # clique -> parent clique (-1 at root)
    parent_sep: List[int]                      # clique -> sep ix to parent (-1 at root)
    children: List[List[Tuple[int, int]]]      # clique -> [(child clique, sep ix)]
    topo_order: List[int] = field(default_factory=list)  # root-first order

    def to_nested(self) -> list:
        """Reference-format recursive tree [c, (s+offset, subtree), ...]."""
        def rec(c: int) -> list:
            node: list = [c]
            for child, sep in self.children[c]:
                node.append((self.num_cliques + sep, rec(child)))
            return node
        return rec(self.root)


def build_junction_tree(
    maxcliques: Sequence[Sequence[int]],
    sizes: Sequence[int],
    root: int = 0,
) -> JunctionTreeStructure:
    n = len(maxcliques)
    if n == 0:
        raise ValueError("cannot build a junction tree with no cliques")
    clique_sets = [set(c) for c in maxcliques]
    weights = []
    for c in maxcliques:
        w = 1
        for v in c:
            w *= sizes[v]
        weights.append(w)

    # candidate separators: only clique pairs sharing >=1 variable (via a
    # var -> cliques inverted index), instead of the reference's all-O(n^2)
    # pairs (construction.py:536-539) — the all-pairs sweep is quadratic in
    # clique count and dominates build time on long chains.  Disconnected
    # components are linked afterwards by empty separators, preserving the
    # reference's join-forests-with-empty-sepsets behavior
    # (construction.py:530).
    num_vars = max((v for c in maxcliques for v in c), default=-1) + 1
    var_cliques: List[List[int]] = [[] for _ in range(num_vars)]
    for ci, c in enumerate(maxcliques):
        for v in c:
            var_cliques[v].append(ci)
    pair_set = set()
    for group in var_cliques:
        for i, a in enumerate(group):
            for b in group[i + 1:]:
                pair_set.add((a, b) if a < b else (b, a))
    candidates: List[Tuple[int, int, int, List[int]]] = []  # (a, b, wsum, sep)
    for a, b in pair_set:
        sep = sorted(clique_sets[a] & clique_sets[b])
        candidates.append((a, b, weights[a] + weights[b], sep))
    # Jensen criterion: largest separator mass first, then smallest weight
    # sum; (a, b) tie-break for determinism.
    candidates.sort(key=lambda t: (-len(t[3]), t[2], t[0], t[1]))

    uf = _UnionFind(n)
    separators: List[List[int]] = []
    edges: List[Tuple[int, int, int]] = []
    for a, b, _, sep in candidates:
        if len(edges) == n - 1:
            break
        if uf.union(a, b):
            sep_ix = len(separators)
            separators.append(sep)
            edges.append((a, b, sep_ix))

    # link remaining components with empty separators (smallest-weight
    # representative per component, matching the min-weight tie-break)
    if len(edges) < n - 1:
        reps: dict = {}
        for ci in range(n):
            r = uf.find(ci)
            if r not in reps or weights[ci] < weights[reps[r]]:
                reps[r] = ci
        comp = sorted(reps.values(), key=lambda ci: (weights[ci], ci))
        for other in comp[1:]:
            if uf.union(comp[0], other):
                sep_ix = len(separators)
                separators.append([])
                edges.append((comp[0], other, sep_ix))

    # root the tree: BFS from `root` over the edge adjacency
    return build_junction_tree_from_edges(n, separators, edges, root)


def reroot(structure: JunctionTreeStructure, new_root: int) -> JunctionTreeStructure:
    """Re-root the tree at another clique (role of reference ``change_root``,
    construction.py:377-408, without the recursive rebuild): same edges, new
    parent/children orientation."""
    return build_junction_tree_from_edges(
        structure.num_cliques, structure.separators, structure.edges, new_root
    )


def build_junction_tree_from_edges(
    num_cliques: int,
    separators: List[List[int]],
    edges: List[Tuple[int, int, int]],
    root: int,
) -> JunctionTreeStructure:
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(num_cliques)]
    for a, b, s in edges:
        adj[a].append((b, s))
        adj[b].append((a, s))
    parent = [-1] * num_cliques
    parent_sep = [-1] * num_cliques
    children: List[List[Tuple[int, int]]] = [[] for _ in range(num_cliques)]
    topo: List[int] = [root]
    seen = [False] * num_cliques
    seen[root] = True
    head = 0
    while head < len(topo):
        c = topo[head]
        head += 1
        for nxt, s in adj[c]:
            if not seen[nxt]:
                seen[nxt] = True
                parent[nxt] = c
                parent_sep[nxt] = s
                children[c].append((nxt, s))
                topo.append(nxt)
    assert all(seen), "edge list does not span all cliques"
    return JunctionTreeStructure(
        num_cliques=num_cliques,
        separators=separators,
        edges=edges,
        root=root,
        parent=parent,
        parent_sep=parent_sep,
        children=children,
        topo_order=topo,
    )


def get_clique(structure: JunctionTreeStructure, clique_vars, var: int):
    """Index of a clique containing ``var``, or None (role of reference
    ``get_clique``, construction.py:6-36)."""
    for ci in structure.topo_order:
        if var in clique_vars[ci]:
            return ci
    return None


def generate_potential_pairs(
    structure: JunctionTreeStructure,
) -> List[Tuple[int, int]]:
    """(clique, separator) pairs for every parent->child edge, separator ids
    offset by the clique count — the canonicalized tree-shape representation
    the reference compares trees with (construction.py:624-640,
    tests/util.py:237-246)."""
    out: List[Tuple[int, int]] = []
    for c in structure.topo_order:
        for child, s in structure.children[c]:
            out.append((c, structure.num_cliques + s))
    return out


def bf_traverse(structure: JunctionTreeStructure) -> List[int]:
    """Clique ids in breadth-first order (reference construction.py:459-477)."""
    return list(structure.topo_order)


def df_traverse(structure: JunctionTreeStructure) -> List[int]:
    """Clique ids in depth-first order (reference construction.py:501-519)."""
    out: List[int] = []
    stack = [structure.root]
    while stack:
        c = stack.pop()
        out.append(c)
        for child, _ in reversed(structure.children[c]):
            stack.append(child)
    return out
