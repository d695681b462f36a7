"""Chain/tree Bayes nets (BASELINE.json config: chains 10-100 vars)."""

from __future__ import annotations

import numpy as np


def chain_bn_model(n: int, card: int = 2, seed: int = 0):
    """Chain BN: P(x0) * prod P(x_i | x_{i-1}), normalized CPDs.

    Returns (factors, sizes, values)."""
    rng = np.random.default_rng(seed)
    factors = [["x0"]]
    prior = rng.random(card) + 0.1
    values = [prior / prior.sum()]
    for i in range(1, n):
        factors.append([f"x{i-1}", f"x{i}"])
        cpd = rng.random((card, card)) + 0.1
        values.append(cpd / cpd.sum(axis=1, keepdims=True))
    sizes = {f"x{i}": card for i in range(n)}
    return factors, sizes, values


def star_bn_model(n_leaves: int, card: int = 3, seed: int = 0):
    """Star BN: one hub, many conditionally independent leaves."""
    rng = np.random.default_rng(seed)
    factors = [["hub"]]
    prior = rng.random(card) + 0.1
    values = [prior / prior.sum()]
    sizes = {"hub": card}
    for i in range(n_leaves):
        leaf = f"leaf{i}"
        factors.append(["hub", leaf])
        cpd = rng.random((card, 2)) + 0.1
        values.append(cpd / cpd.sum(axis=1, keepdims=True))
        sizes[leaf] = 2
    return factors, sizes, values
