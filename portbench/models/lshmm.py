"""The Li-Stephens haplotype-copying HMM (Li and Stephens 2003, Genetics
165:2213-2233) at IMPUTE2's default settings (Howie, Donnelly and Marchini
2009, PLoS Genetics 5(6):e1000529: K = 500 template haplotypes, Ne =
20,000).

A frozen copy of the program's generator
(``junctiontree_tpu_torch.models.hmm.li_stephens_model``): the same seed
gives the same factors and values.  Hidden ``x{m}`` (which template the
target copies at site m, K states), allele leaves ``y{m}`` (0/1); a uniform
prior on ``x0``; transitions exp(-rho_m/K) I + (1 - exp(-rho_m/K))/K with
rho_m = 4 Ne r d_m on a constant map; emissions 1 - theta/(2(K + theta))
for the template's allele and theta/(2(K + theta)) for the other, theta =
1 / H_{K-1}; the panel's allele counts from the neutral spectrum with the
ancestral allele unknown (U-shaped), spacing exponential."""

from __future__ import annotations

import numpy as np


def build(cfg: dict):
    """(factors, sizes, values) of the configuration ``cfg``."""
    return li_stephens_model(cfg["templates"], cfg["sites"],
                             cfg["model_seed"], cfg["Ne"], cfg["cm_per_mb"],
                             cfg["mean_spacing_bp"])


def li_stephens_model(K, M, seed, Ne, cm_per_mb, mean_spacing_bp):
    rng = np.random.default_rng(seed)
    # the panel: each site polymorphic, P(i carriers) ~ 1/i + 1/(K - i)
    i = np.arange(1, K)
    p = 1.0 / i + 1.0 / (K - i)
    counts = rng.choice(i, size=M, p=p / p.sum())
    panel = np.zeros((K, M), dtype=np.int64)
    for m, c in enumerate(counts):
        panel[rng.choice(K, size=c, replace=False), m] = 1
    spacing = rng.exponential(mean_spacing_bp, size=M - 1)
    rho = 4.0 * Ne * (cm_per_mb * 1e-8) * spacing
    theta = 1.0 / float(np.sum(1.0 / np.arange(1, K)))
    miss = theta / (2.0 * (K + theta))
    x = [f"x{m}" for m in range(M)]
    y = [f"y{m}" for m in range(M)]
    factors = [[x[0]]]
    values = [np.full(K, 1.0 / K)]
    for m in range(M):
        if m > 0:
            stay = np.exp(-rho[m - 1] / K)
            factors.append([x[m - 1], x[m]])
            values.append(stay * np.eye(K) + (1.0 - stay) / K)
        factors.append([x[m], y[m]])
        emit = np.full((K, 2), miss)
        emit[np.arange(K), panel[:, m]] = 1.0 - miss
        values.append(emit)
    sizes = {**{v: K for v in x}, **{v: 2 for v in y}}
    return factors, sizes, values
