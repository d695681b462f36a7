"""Ising-style grid MRFs — the headline benchmark family
(BASELINE.json configs; BASELINE.md measured the reference at ~138 queries/s
on the 6x6 binary grid, single CPU core)."""

from __future__ import annotations

import numpy as np


def grid_mrf_model(rows: int, cols: int, card: int = 2, coupling: float = 1.0,
                   field: float = 0.5, seed: int = 0):
    """Pairwise grid MRF with random unary fields and smooth couplings.

    Returns (factors, sizes, values); potentials are strictly positive
    exp-family terms so linear-space propagation is well-conditioned at
    benchmark scales."""
    rng = np.random.default_rng(seed)

    def name(r, c):
        return f"g{r}_{c}"

    factors, values = [], []
    for r in range(rows):
        for c in range(cols):
            factors.append([name(r, c)])
            values.append(np.exp(field * rng.standard_normal(card)))
            if r + 1 < rows:
                factors.append([name(r, c), name(r + 1, c)])
                values.append(np.exp(coupling * rng.standard_normal((card, card))))
            if c + 1 < cols:
                factors.append([name(r, c), name(r, c + 1)])
                values.append(np.exp(coupling * rng.standard_normal((card, card))))
    sizes = {name(r, c): card for r in range(rows) for c in range(cols)}
    return factors, sizes, values
