"""Chow-Liu structure learning: optimal tree-structured BN from data
(counterpart of ``junctiontree_tpu/structure.py``).

The classic Chow-Liu algorithm (the maximum-likelihood tree: maximum
spanning tree of pairwise mutual information), giving a complete
data -> structure -> parameters -> exact inference story:

    factors, sizes, values, edges = chow_liu(data, labels, cards)
    eng = jt.create_junction_tree(factors, sizes).engine().set_potentials(values)

The O(V^2 K^2 N) pairwise-count computation is ONE product over a one-hot
design tensor ([N, V, K] -> [V, V, K, K]) on the device, batched over
observations, with no per-pair Python loops.  The O(V^2 log V) spanning
tree and the CPD normalization run on the host: they are microseconds at
any realistic V.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .executor import resolve_device


def pairwise_counts(
    data: np.ndarray, cards: Sequence[int], device=None
) -> np.ndarray:
    """Joint count tensor [V, V, K, K] from complete data [N, V] (int
    states), K = max cardinality; invalid (padded) state cells are zero.

    One one-hot matrix product on ``device`` (default CUDA device 0): counts
    are sums of 0/1 products, exact in float32 up to 2^24 observations."""
    device = resolve_device(device)
    data = np.asarray(data)
    N, V = data.shape
    K = int(max(cards))
    if data.min() < 0 or data.max() >= K:
        raise ValueError(f"states must lie in [0, {K}) for these cards")
    oh = torch.nn.functional.one_hot(
        torch.as_tensor(data, dtype=torch.int64, device=device), K
    ).to(torch.float32).reshape(N, V * K)                      # [N, (v, i)]
    counts = (oh.t() @ oh).reshape(V, K, V, K).permute(0, 2, 1, 3)
    return counts.cpu().numpy()

def mutual_information(
    counts: np.ndarray, cards: Sequence[int], alpha: float = 0.0
) -> np.ndarray:
    """Pairwise MI matrix [V, V] from the joint count tensor.

    ``alpha``: Laplace smoothing added per VALID joint cell (padded cells
    stay structural zeros so mixed cardinalities don't bias the estimate)."""
    V, _, K, _ = counts.shape
    cards = np.asarray(cards)
    mi = np.zeros((V, V))
    for v in range(V):
        for w in range(V):
            if w <= v:
                continue
            c = counts[v, w, : cards[v], : cards[w]].astype(np.float64)
            if alpha:
                c = c + alpha
            n = c.sum()
            if n <= 0:
                continue
            p = c / n
            pv = p.sum(axis=1, keepdims=True)
            pw = p.sum(axis=0, keepdims=True)
            with np.errstate(divide="ignore", invalid="ignore"):
                t = p * (np.log(p) - np.log(pv) - np.log(pw))
            mi[v, w] = mi[w, v] = float(np.nansum(t))
    return mi


def _max_spanning_tree(weights: np.ndarray) -> List[Tuple[int, int]]:
    """Kruskal max spanning tree on a dense symmetric weight matrix."""
    V = weights.shape[0]
    iu = np.triu_indices(V, k=1)
    order = np.argsort(-weights[iu], kind="stable")
    parent = list(range(V))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edges: List[Tuple[int, int]] = []
    for ix in order:
        a, b = int(iu[0][ix]), int(iu[1][ix])
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
            edges.append((a, b))
            if len(edges) == V - 1:
                break
    return edges


def chow_liu(
    data: np.ndarray,
    labels: Optional[Sequence[Hashable]] = None,
    cards: Optional[Sequence[int]] = None,
    alpha: float = 1.0,
    root: int = 0,
    device=None,
):
    """Fit the maximum-likelihood tree-structured BN (Chow & Liu 1968).

    data: [N, V] int observation matrix (complete data).
    labels: variable labels (default 0..V-1); cards: per-var cardinalities
    (default inferred as max observed state + 1); alpha: Laplace smoothing
    for the CPDs (and MI estimation at alpha/N scale).

    Returns ``(factors, sizes, values, edges)`` ready for
    ``create_junction_tree(factors, sizes)`` + ``set_potentials(values)``:
    one unary factor for the root marginal and one pairwise factor
    [parent, child] holding P(child | parent) per tree edge.  ``edges`` are
    the chosen (parent, child) label pairs.  The pairwise counts are taken
    on ``device`` (default CUDA device 0; ``"cpu"`` runs on the CPU)."""
    data = np.asarray(data)
    if data.ndim != 2:
        raise ValueError(f"data must be [N, V], got shape {data.shape}")
    N, V = data.shape
    if N < 1 or V < 1:
        raise ValueError("need at least one observation and one variable")
    if labels is None:
        labels = list(range(V))
    labels = list(labels)
    if len(labels) != V:
        raise ValueError(f"{len(labels)} labels for {V} data columns")
    if cards is None:
        cards = [int(data[:, v].max()) + 1 for v in range(V)]
    cards = [int(c) for c in cards]

    counts = pairwise_counts(data, cards, device)
    mi = mutual_information(counts, cards, alpha=alpha / max(N, 1))
    und_edges = _max_spanning_tree(mi)

    # orient away from the root (BFS)
    adj: Dict[int, List[int]] = {v: [] for v in range(V)}
    for a, b in und_edges:
        adj[a].append(b)
        adj[b].append(a)
    parent_of: Dict[int, Optional[int]] = {root: None}
    order = [root]
    for v in order:
        for w in adj[v]:
            if w not in parent_of:
                parent_of[w] = v
                order.append(w)
    # disconnected components (V == 1, or degenerate MI ties): root each
    # separately and keep orienting within its component
    for v in range(V):
        if v not in parent_of:
            parent_of[v] = None
            comp = [v]
            for x in comp:
                for w in adj[x]:
                    if w not in parent_of:
                        parent_of[w] = x
                        comp.append(w)

    sizes = {labels[v]: cards[v] for v in range(V)}
    factors: List[List[Hashable]] = []
    values: List[np.ndarray] = []
    edges: List[Tuple[Hashable, Hashable]] = []
    for v in range(V):
        p = parent_of[v]
        if p is None:
            # root marginal from smoothed unary counts
            c = counts[v, v].diagonal()[: cards[v]].astype(np.float64) + alpha
            factors.append([labels[v]])
            values.append(c / c.sum())
        else:
            c = counts[p, v][: cards[p], : cards[v]].astype(np.float64) + alpha
            cpd = c / c.sum(axis=1, keepdims=True)   # P(v | p)
            factors.append([labels[p], labels[v]])
            values.append(cpd)
            edges.append((labels[p], labels[v]))
    return factors, sizes, values, edges
