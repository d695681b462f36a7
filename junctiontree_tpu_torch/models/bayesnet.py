"""Random Bayes-net generators at classic-network scale.

BASELINE.json lists ALARM / Insurance / Hailfinder-class networks (mixed
cardinalities, a few dozen nodes).  Their published CPTs aren't vendored
here; instead ``random_bayesnet`` generates DAG-structured CPD factor graphs
with matched scale (node count, fan-in, cardinality mix) for benchmarking and
differential testing, and ``alarm_like`` pins the ALARM-class shape
(37 nodes, max fan-in 3, cards 2-4)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def random_bayesnet(
    n_nodes: int,
    max_parents: int = 3,
    cards=(2, 3, 4),
    seed: int = 0,
):
    """Random DAG BN: each node picks up to ``max_parents`` parents among
    earlier nodes; CPDs are random and normalized over the child axis.

    Returns (factors, sizes, values) where factor i is
    [parents..., node_i] with the CPD normalized along the last axis."""
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(n_nodes)]
    sizes: Dict[str, int] = {
        v: int(rng.choice(cards)) for v in names
    }
    factors: List[List[str]] = []
    values: List[np.ndarray] = []
    for i, v in enumerate(names):
        k = int(rng.integers(0, min(max_parents, i) + 1))
        parents = (
            sorted(rng.choice(i, size=k, replace=False).tolist()) if k else []
        )
        scope = [names[p] for p in parents] + [v]
        factors.append(scope)
        shape = tuple(sizes[x] for x in scope)
        cpd = rng.random(shape) + 0.05
        cpd = cpd / cpd.sum(axis=-1, keepdims=True)
        values.append(cpd)
    return factors, sizes, values


def banded_bayesnet(
    n_nodes: int,
    band: int = 6,
    max_parents: int = 2,
    cards=(2, 3),
    seed: int = 0,
):
    """Bounded-treewidth random BN: parents drawn only from the ``band``
    immediately preceding nodes, so the moral graph has bandwidth <= band
    and treewidth stays <= band regardless of scale — the realistic shape
    for large networks where exact inference remains tractable (unbounded
    random DAGs have treewidth Θ(n): an 800-node random_bayesnet hits
    treewidth ~41 = 10^16-state cliques, infeasible for ANY exact engine)."""
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(n_nodes)]
    sizes: Dict[str, int] = {v: int(rng.choice(cards)) for v in names}
    factors: List[List[str]] = []
    values: List[np.ndarray] = []
    for i, v in enumerate(names):
        lo = max(0, i - band)
        k = int(rng.integers(0, min(max_parents, i - lo) + 1))
        parents = (
            sorted(rng.choice(np.arange(lo, i), size=k, replace=False).tolist())
            if k
            else []
        )
        scope = [names[p] for p in parents] + [v]
        factors.append(scope)
        shape = tuple(sizes[x] for x in scope)
        cpd = rng.random(shape) + 0.05
        values.append(cpd / cpd.sum(axis=-1, keepdims=True))
    return factors, sizes, values


def alarm_like(seed: int = 0):
    """ALARM-class BN: 37 nodes, mixed cardinalities 2-4, max fan-in 3."""
    return random_bayesnet(37, max_parents=3, cards=(2, 2, 3, 4), seed=seed)


def insurance_like(seed: int = 0):
    """Insurance-class BN: 27 nodes, cards up to 5."""
    return random_bayesnet(27, max_parents=3, cards=(2, 3, 4, 5), seed=seed)


def hailfinder_like(seed: int = 0):
    """Hailfinder-class BN: 56 nodes, cards up to 11 (kept <=6 here to bound
    clique state spaces for CI; scale knob for benchmarks)."""
    return random_bayesnet(56, max_parents=4, cards=(2, 3, 4, 5, 6), seed=seed)
