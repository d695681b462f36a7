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


def ising_grid_model(rows: int, cols: int, coupling_scale: float,
                     field_scale: float = 1.0, seed: int = 0):
    """Ising spin glass on a ``rows`` x ``cols`` lattice: the recipe of the
    "Grids" class of the UAI inference evaluations (e.g. grid20x20.f10 is
    20 x 20 with ``coupling_scale`` 10).

    Spins x in {-1, +1} are held as states {0, 1} (state s is x = 2s - 1)
    of the variables ``s{r}_{c}``.  Each site has the unary factor
    exp(theta_i x_i), theta_i ~ U[-field_scale, field_scale], and each
    lattice edge the pair factor exp(theta_ij x_i x_j), theta_ij ~
    U[-coupling_scale, coupling_scale] (mixed signs: frustrated).  Values
    come from ``numpy.random.default_rng(seed)`` in this order: one
    ``uniform`` call for the rows * cols fields in raster order, then one
    for the couplings of the edges in raster order of their first site,
    its right edge before its down edge.  Factors: the unaries in raster
    order, then the pairs in that edge order.

    Returns (factors, sizes, values), the values linear and float64."""
    rng = np.random.default_rng(seed)

    def name(r, c):
        return f"s{r}_{c}"

    edges = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.append(((r, c), (r, c + 1)))
            if r + 1 < rows:
                edges.append(((r, c), (r + 1, c)))
    fields = rng.uniform(-field_scale, field_scale, size=rows * cols)
    couplings = rng.uniform(-coupling_scale, coupling_scale, size=len(edges))
    spin = np.array([-1.0, 1.0])
    factors = [[name(r, c)] for r in range(rows) for c in range(cols)]
    values = [np.exp(t * spin) for t in fields]
    for (a, b), t in zip(edges, couplings):
        factors.append([name(*a), name(*b)])
        values.append(np.exp(t * np.outer(spin, spin)))
    sizes = {name(r, c): 2 for r in range(rows) for c in range(cols)}
    return factors, sizes, values
