"""Min-fill triangulation (host-side compile phase).

Behavioral equivalent of the reference's ``find_triangulation``
(reference construction.py:176-353): min-fill elimination
with min-weight tie-break (weight = product of variable sizes over the closed
neighborhood, construction.py:98-108), maximal-clique extraction with
subset-reuse (construction.py:260-272), and factor->maxclique assignment.

Differences, by design (TPU-first rebuild, not a port):
  * all variables are pre-interned ints (no string-comparison heap hazard);
  * scores are updated incrementally (only vars whose neighborhood changed are
    rescored) instead of rebuilding a global heap after every elimination
    (reference construction.py:166-172 is O(V*E) per step — the measured
    scalability cliff in SURVEY.md §6);
  * ties beyond (fill, weight) break on the smallest interned id, which is the
    label insertion order — deterministic for any hashable labels;
  * each factor is assigned to the smallest-weight maxclique containing it
    (the reference assigns to the clique formed when the factor is first
    touched, construction.py:350-351 — either choice yields correct marginals).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Set, Tuple


@dataclass(frozen=True)
class Triangulation:
    """Result of triangulating a factor graph (all vars are interned ints)."""

    maxcliques: List[List[int]]          # sorted var ids per maximal clique
    factor_to_maxclique: List[int]       # factor ix -> clique ix (-1: empty-scope)
    elimination_order: List[int]         # var ids in elimination order
    fill_edges: List[Tuple[int, int]]    # added chordalization edges
    treewidth: int                       # max clique size - 1

    @property
    def num_cliques(self) -> int:
        return len(self.maxcliques)


def build_adjacency(factors: Sequence[Sequence[int]], num_vars: int) -> List[Set[int]]:
    """Undirected moral graph: vars co-occurring in a factor are adjacent.

    Mirrors reference ``factors_to_undirected_graph`` (construction.py:39-55)
    but as int adjacency sets rather than a frozenset-edge -> factor-set map.
    """
    adj: List[Set[int]] = [set() for _ in range(num_vars)]
    for f in factors:
        for i, u in enumerate(f):
            for v in f[i + 1:]:
                adj[u].add(v)
                adj[v].add(u)
    return adj


def _fill_count(adj: List[Set[int]], v: int) -> int:
    """Number of edges that eliminating v would add among its neighbors."""
    nbrs = list(adj[v])
    n = len(nbrs)
    missing = 0
    for i in range(n):
        ai = adj[nbrs[i]]
        for j in range(i + 1, n):
            if nbrs[j] not in ai:
                missing += 1
    return missing


def _weight(adj: List[Set[int]], sizes: Sequence[int], v: int) -> int:
    """Product of sizes over the closed neighborhood of v (construction.py:107)."""
    w = sizes[v]
    for u in adj[v]:
        w *= sizes[u]
    return w


def min_fill_triangulation(
    factors: Sequence[Sequence[int]],
    sizes: Sequence[int],
    heuristic: str = "min_fill",
) -> Triangulation:
    """Eliminate all variables by a greedy heuristic order, collecting
    maximal cliques and the chordalizing fill edges.

    heuristic: 'min_fill' (fill count, weight tie-break — reference
    behavior), 'min_degree' (neighborhood size first), or 'min_weight'
    (closed-neighborhood state space first)."""
    import heapq

    num_vars = len(sizes)
    adj = build_adjacency(factors, num_vars)
    remaining: Set[int] = set(range(num_vars))

    # lazy-invalidation heap over (fill, weight, id): stale entries are
    # skipped on pop via a per-var version counter — O(E log V) overall vs
    # the reference's full heap rebuild per elimination step
    # (construction.py:166-172) and vs an O(V) min-scan per step.
    if heuristic == "min_fill":
        score = lambda v: (_fill_count(adj, v), _weight(adj, sizes, v))
    elif heuristic == "min_degree":
        score = lambda v: (len(adj[v]), _weight(adj, sizes, v))
    elif heuristic == "min_weight":
        score = lambda v: (_weight(adj, sizes, v), _fill_count(adj, v))
    elif heuristic.startswith("min_fill_random"):
        # randomized tie-break among equal-fill candidates (classic
        # best-of-k restart improvement over greedy min-fill); seed after
        # the colon, e.g. "min_fill_random:3"
        import numpy as _np

        seed = int(heuristic.split(":", 1)[1]) if ":" in heuristic else 0
        rng = _np.random.default_rng(seed)
        score = lambda v: (_fill_count(adj, v), rng.random())
    else:
        raise ValueError(f"unknown elimination heuristic {heuristic!r}")

    version: List[int] = [0] * num_vars
    heap: List[Tuple[int, int, int, int]] = []
    for v in remaining:
        heap.append((*score(v), v, 0))
    heapq.heapify(heap)

    def rescore(v: int) -> None:
        version[v] += 1
        heapq.heappush(heap, (*score(v), v, version[v]))

    maxcliques: List[List[int]] = []
    clique_sets: List[Set[int]] = []
    var_in_cliques: List[List[int]] = [[] for _ in range(num_vars)]
    elim_order: List[int] = []
    fill_edges: List[Tuple[int, int]] = []

    while remaining:
        # pick min (fill, weight, id), skipping stale heap entries
        while True:
            fill, weight, best, ver = heapq.heappop(heap)
            if best in remaining and ver == version[best]:
                break
        elim_order.append(best)

        nbrs = [u for u in adj[best] if u in remaining]
        cluster = set(nbrs)
        cluster.add(best)

        # add fill edges among the neighbors
        dirty: Set[int] = set()
        for i, u in enumerate(nbrs):
            for w in nbrs[i + 1:]:
                if w not in adj[u]:
                    adj[u].add(w)
                    adj[w].add(u)
                    fill_edges.append((u, w) if u < w else (w, u))
                    dirty.add(u)
                    dirty.add(w)

        # remove best from the graph
        for u in nbrs:
            adj[u].discard(best)
        remaining.discard(best)

        # record the cluster as a maxclique unless contained in an existing
        # one (reference find_maxclique, construction.py:260-272); only
        # cliques containing `best` can contain the cluster
        for ci in var_in_cliques[best]:
            if cluster <= clique_sets[ci]:
                break
        else:
            ci_new = len(clique_sets)
            clique_sets.append(cluster)
            maxcliques.append(sorted(cluster))
            for v in cluster:
                var_in_cliques[v].append(ci_new)

        # rescore: any var whose neighborhood changed (neighbors of best, and
        # endpoints of new fill edges affect their neighbors' fill counts)
        to_rescore: Set[int] = set(nbrs)
        for u in dirty:
            to_rescore.update(x for x in adj[u] if x in remaining)
        for v in to_rescore:
            if v in remaining:
                rescore(v)

    return _finish_triangulation(
        factors, sizes, maxcliques, clique_sets, var_in_cliques,
        elim_order, fill_edges,
    )


def _finish_triangulation(
    factors, sizes, maxcliques, clique_sets, var_in_cliques,
    elim_order, fill_edges,
) -> Triangulation:
    """Shared tail: assign each factor to its smallest-weight containing
    maxclique (empty-scope factors get -1) and package the result."""
    clique_weights = [1 for _ in maxcliques]
    for ci, c in enumerate(maxcliques):
        w = 1
        for v in c:
            w *= sizes[v]
        clique_weights[ci] = w

    factor_to_maxclique: List[int] = []
    for f in factors:
        if len(f) == 0:
            factor_to_maxclique.append(-1)
            continue
        fset = set(f)
        best_ci = -1
        best_w = None
        # only cliques containing f's first variable can contain f
        for ci in var_in_cliques[f[0]]:
            if fset <= clique_sets[ci]:
                if best_w is None or clique_weights[ci] < best_w:
                    best_ci, best_w = ci, clique_weights[ci]
        if best_ci < 0:
            raise AssertionError(
                "no maxclique contains factor %r — elimination invariant broken" % (f,)
            )
        factor_to_maxclique.append(best_ci)

    treewidth = max((len(c) for c in maxcliques), default=1) - 1
    return Triangulation(
        maxcliques=maxcliques,
        factor_to_maxclique=factor_to_maxclique,
        elimination_order=elim_order,
        fill_edges=fill_edges,
        treewidth=treewidth,
    )


def triangulation_from_order(
    factors: Sequence[Sequence[int]],
    sizes: Sequence[int],
    order: Sequence[int],
) -> Triangulation:
    """Eliminate variables in the GIVEN order (same clique extraction and
    factor assignment as the greedy path).  The workhorse for annealing and
    for replaying a saved elimination order."""
    num_vars = len(sizes)
    adj = build_adjacency(factors, num_vars)
    remaining: Set[int] = set(range(num_vars))
    maxcliques: List[List[int]] = []
    clique_sets: List[Set[int]] = []
    var_in_cliques: List[List[int]] = [[] for _ in range(num_vars)]
    fill_edges: List[Tuple[int, int]] = []
    for best in order:
        nbrs = [u for u in adj[best] if u in remaining]
        cluster = set(nbrs)
        cluster.add(best)
        for i, u in enumerate(nbrs):
            for w in nbrs[i + 1:]:
                if w not in adj[u]:
                    adj[u].add(w)
                    adj[w].add(u)
                    fill_edges.append((u, w) if u < w else (w, u))
        for u in nbrs:
            adj[u].discard(best)
        remaining.discard(best)
        for ci in var_in_cliques[best]:
            if cluster <= clique_sets[ci]:
                break
        else:
            ci_new = len(clique_sets)
            clique_sets.append(cluster)
            maxcliques.append(sorted(cluster))
            for v in cluster:
                var_in_cliques[v].append(ci_new)
    if remaining:
        raise ValueError("order must eliminate every variable exactly once")
    return _finish_triangulation(
        factors, sizes, maxcliques, clique_sets, var_in_cliques,
        list(order), fill_edges,
    )


def _order_cost(
    factors: Sequence[Sequence[int]],
    sizes: Sequence[int],
    order: Sequence[int],
) -> float:
    """log total clique state space of eliminating in the given order
    (cheap simulation: no clique/fill bookkeeping)."""
    import math

    num_vars = len(sizes)
    adj = build_adjacency(factors, num_vars)
    remaining = [True] * num_vars
    total = 0
    for best in order:
        nbrs = [u for u in adj[best] if remaining[u]]
        w = sizes[best]
        for u in nbrs:
            w *= sizes[u]
        total += w
        for i, u in enumerate(nbrs):
            au = adj[u]
            for x in nbrs[i + 1:]:
                if x not in au:
                    au.add(x)
                    adj[x].add(u)
            au.discard(best)
        remaining[best] = False
    return math.log(max(total, 1))


def anneal_triangulation(
    factors: Sequence[Sequence[int]],
    sizes: Sequence[int],
    time_budget_s: float = 2.0,
    seed: int = 0,
    init: Triangulation = None,
    steps: int = None,
) -> Triangulation:
    """Simulated annealing over elimination orders (Kjaerulff-style).

    Starts from the portfolio winner (or ``init``), proposes random
    position moves of single variables, and accepts by Metropolis on the
    log total clique state space with a geometric temperature schedule.
    Greedy min-fill is typically 2-6 above the optimal treewidth on grids
    (SURVEY.md §6: the reference's 8x8 grid blows up to 2^18 states);
    annealing reliably recovers most of that gap at a bounded, one-time
    compile cost."""
    import math
    import time as _time

    import numpy as np

    if init is None:
        init = portfolio_triangulation(factors, sizes, random_restarts=8)
    order = list(init.elimination_order)
    n = len(order)
    if n < 3:
        return init
    rng = np.random.default_rng(seed)
    cost = _order_cost(factors, sizes, order)
    best_order = list(order)
    best_cost = cost
    # costs are log(total states): typical useful deltas are 1e-3..1e-1,
    # so temperatures must sit well below that or SA random-walks
    T0, T1 = 0.02, 5e-4
    if steps is not None:
        # fixed step budget: fully deterministic trajectory (same factors,
        # sizes, seed -> same triangulation -> same compiled program, so
        # the persistent XLA cache hits across processes).  The
        # auto-escalation path uses this.
        t_end = float("inf")
    else:
        t_end = _time.perf_counter() + time_budget_s
        # estimate a step budget from a few timed evaluations, then anneal
        t0 = _time.perf_counter()
        for _ in range(3):
            _order_cost(factors, sizes, order)
        per_eval = max((_time.perf_counter() - t0) / 3, 1e-6)
        steps = max(20, int((t_end - _time.perf_counter()) / per_eval))
    for s in range(steps):
        if _time.perf_counter() > t_end:
            break
        T = T0 * (T1 / T0) ** (s / max(steps - 1, 1))
        i = int(rng.integers(n))
        # mostly local relocations (cheap, fine-grained), occasional jumps
        if rng.random() < 0.8:
            j = min(n - 1, max(0, i + int(rng.integers(-6, 7))))
        else:
            j = int(rng.integers(n))
        if i == j:
            continue
        prop = list(order)
        v = prop.pop(i)
        prop.insert(j, v)
        c = _order_cost(factors, sizes, prop)
        if c <= cost or rng.random() < math.exp((cost - c) / T):
            order, cost = prop, c
            if cost < best_cost:
                best_order, best_cost = list(order), cost
    tri = triangulation_from_order(factors, sizes, best_order)
    # never worse than the starting point
    if total_states(tri, sizes) <= total_states(init, sizes):
        return tri
    return init


def total_states(tri: Triangulation, sizes: Sequence[int]) -> int:
    """Sum of clique state spaces — the propagation cost proxy."""
    total = 0
    for c in tri.maxcliques:
        w = 1
        for v in c:
            w *= sizes[v]
        total += w
    return total


PORTFOLIO = ("min_fill", "min_degree", "min_weight")


def portfolio_triangulation(
    factors: Sequence[Sequence[int]],
    sizes: Sequence[int],
    heuristics: Sequence[str] = PORTFOLIO,
    random_restarts: int = 0,
) -> Triangulation:
    """Run several elimination heuristics (plus optional randomized
    min-fill restarts) and keep the triangulation with the smallest total
    clique state space.  Compile time multiplies by the portfolio size;
    propagation cost often drops substantially (greedy heuristics dominate
    each other on different graph families, and randomized tie-breaks
    escape greedy min-fill's worst cases)."""
    hs = list(heuristics) + [
        f"min_fill_random:{k}" for k in range(random_restarts)
    ]
    best = None
    best_cost = None
    for h in hs:
        tri = min_fill_triangulation(factors, sizes, heuristic=h)
        cost = total_states(tri, sizes)
        if best_cost is None or cost < best_cost:
            best, best_cost = tri, cost
    return best
