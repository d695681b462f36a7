"""Compatibility facade with the reference's ``junctiontree.construction``
module surface, mapped onto the compiler (counterpart of
``junctiontree_tpu/construction.py``):

  reference                      ->  here
  ------------------------------------------------------------------
  find_triangulation              -> find_triangulation (same tuple shape)
  construct_junction_tree         -> construct_junction_tree
  factors_to_undirected_graph     -> build_adjacency (int adjacency sets)
  bf_traverse / df_traverse       -> bf_traverse / df_traverse
  get_clique                      -> get_clique
  generate_potential_pairs        -> generate_potential_pairs
  merge_trees/change_root/insert_sepset -> same names (surgery.py), plus
                                     int-space reroot / build_junction_tree_from_edges

All functions here accept and return *label-space* structures like the
reference; the int-space primitives live in triangulate.py / treebuild.py."""

from __future__ import annotations

from typing import Dict, Hashable, List, Sequence, Tuple

from .labels import intern_factors
from .treebuild import (  # noqa: F401
    JunctionTreeStructure,
    bf_traverse,
    build_junction_tree,
    build_junction_tree_from_edges,
    df_traverse,
    generate_potential_pairs,
    get_clique,
    reroot,
)
from .triangulate import build_adjacency, min_fill_triangulation  # noqa: F401
from .surgery import change_root, insert_sepset, merge_trees  # noqa: F401


def find_triangulation(
    factors: Sequence[Sequence[Hashable]], sizes: Dict[Hashable, int]
) -> Tuple[List[Tuple[Hashable, Hashable]], List[List[Hashable]], List[int]]:
    """Reference-shaped triangulation result (fill_edges, maxcliques,
    factor_to_maxclique), in label space."""
    table, int_factors, int_sizes = intern_factors(factors, sizes)
    tri = min_fill_triangulation(int_factors, int_sizes)
    fill = [
        (table.label_of(a), table.label_of(b)) for a, b in tri.fill_edges
    ]
    cliques = [table.labels_of(c) for c in tri.maxcliques]
    return fill, cliques, list(tri.factor_to_maxclique)


def construct_junction_tree(
    maxcliques: Sequence[Sequence[Hashable]], sizes: Dict[Hashable, int]
) -> Tuple[list, List[List[Hashable]]]:
    """Reference-shaped tree build: returns the recursive nested tree
    [c, (sep+offset, subtree), ...] and the separator variable lists, in
    label space."""
    labels: Dict[Hashable, int] = {}
    for c in maxcliques:
        for v in c:
            labels.setdefault(v, len(labels))
    rev = {i: v for v, i in labels.items()}
    int_cliques = [[labels[v] for v in c] for c in maxcliques]
    int_sizes = [0] * len(labels)
    for v, i in labels.items():
        int_sizes[i] = int(sizes[v])
    tree = build_junction_tree(int_cliques, int_sizes)
    separators = [[rev[v] for v in s] for s in tree.separators]
    return tree.to_nested(), separators


def find_subtree(tree, clique_ix: int) -> bool:
    """True iff a subtree rooted at node ``clique_ix`` exists in the
    nested-list ``tree`` (the reference's name and contract; the compiler
    itself builds trees from edge lists, so this exists for API parity).
    Child entries are ``(sep_ix, subtree)`` tuples, so offset separator ids
    match too."""
    if tree[0] == clique_ix:
        return True
    if len(tree) == 1:
        return False
    return any(find_subtree(child, clique_ix) for child in tree[1:])
