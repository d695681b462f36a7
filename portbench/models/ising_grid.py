"""Ising spin glass on a lattice: the recipe of the UAI inference
evaluations' "Grids" class.

A frozen copy of the program's ``models.grid.ising_grid_model``: spins
x in {-1, +1} held as states {0, 1} of ``s{r}_{c}``; unary factors
exp(theta_i x_i), theta_i ~ U[-field_scale, field_scale]; pair factors
exp(theta_ij x_i x_j) on the lattice edges, theta_ij ~ U[-coupling_scale,
coupling_scale]; from ``numpy.random.default_rng(model_seed)``: the fields in
raster order, then the couplings of the edges in raster order of their
first site, its right edge before its down edge."""

from __future__ import annotations

import numpy as np


def build(cfg: dict):
    """(factors, sizes, values) of the configuration ``cfg``."""
    rows, cols = cfg["rows"], cfg["cols"]
    rng = np.random.default_rng(cfg["model_seed"])

    def name(r, c):
        return f"s{r}_{c}"

    edges = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.append(((r, c), (r, c + 1)))
            if r + 1 < rows:
                edges.append(((r, c), (r + 1, c)))
    f, g = cfg["field_scale"], cfg["coupling_scale"]
    fields = rng.uniform(-f, f, size=rows * cols)
    couplings = rng.uniform(-g, g, size=len(edges))
    spin = np.array([-1.0, 1.0])
    factors = [[name(r, c)] for r in range(rows) for c in range(cols)]
    values = [np.exp(t * spin) for t in fields]
    for (a, b), t in zip(edges, couplings):
        factors.append([name(*a), name(*b)])
        values.append(np.exp(t * np.outer(spin, spin)))
    sizes = {name(r, c): 2 for r in range(rows) for c in range(cols)}
    return factors, sizes, values
