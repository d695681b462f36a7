"""A random DAG-structured Bayes net at a stated scale.

A frozen copy of the program's ``models.random_bayesnet``: node ``i``
takes up to ``max_in_degree`` parents among the earlier nodes, and its CPD
is ``rng.random + cpd_offset``, normalized over the child axis, all from
``numpy.random.default_rng(model_seed)``."""

from __future__ import annotations

import numpy as np


def build(cfg: dict):
    """(factors, sizes, values) of the configuration ``cfg``."""
    rng = np.random.default_rng(cfg["model_seed"])
    n, max_parents = cfg["nodes"], cfg["max_in_degree"]
    names = [f"n{i}" for i in range(n)]
    sizes = {v: int(rng.choice(cfg["cards"])) for v in names}
    factors, values = [], []
    for i, v in enumerate(names):
        k = int(rng.integers(0, min(max_parents, i) + 1))
        parents = (sorted(rng.choice(i, size=k, replace=False).tolist())
                   if k else [])
        scope = [names[p] for p in parents] + [v]
        factors.append(scope)
        cpd = rng.random(tuple(sizes[x] for x in scope)) + cfg["cpd_offset"]
        values.append(cpd / cpd.sum(axis=-1, keepdims=True))
    return factors, sizes, values
