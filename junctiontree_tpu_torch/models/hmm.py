"""Li-Stephens haplotype-copying HMM (Li and Stephens 2003, Genetics
165:2213-2233), at the settings IMPUTE2 serves it with by default (Howie,
Donnelly and Marchini 2009, PLoS Genetics 5(6):e1000529: ``-k_hap 500``
template haplotypes, ``-Ne 20000``).

A target haplotype is a mosaic of K template haplotypes of a reference
panel.  The hidden chain X_0 .. X_{M-1} says which template it copies at
each of M sites; the observed allele leaf Y_m (0 or 1) of site m hangs off
X_m.  With the mutation rate theta = (sum_{k=1}^{K-1} 1/k)^-1:

  P(Y_m = a | X_m = k) = 1 - theta / (2 (K + theta))  if panel[k, m] == a
                         theta / (2 (K + theta))      otherwise
  P(X_m = j | X_{m-1} = i) = exp(-rho_m / K) [i == j]
                             + (1 - exp(-rho_m / K)) / K
  rho_m = 4 Ne r d_m,  r the recombination rate a base pair, d_m the
  spacing of sites m - 1 and m in base pairs.

Imputation observes the alleles at the typed sites and reads the allele
posteriors (dosages) at the others, and the log-likelihood of the target.
"""

from __future__ import annotations

import numpy as np


def mutation_rate(K: int) -> float:
    """Li and Stephens' theta for K templates: the inverse of the harmonic
    number H_{K-1}."""
    return 1.0 / float(np.sum(1.0 / np.arange(1, K)))


def panel_alleles(K: int, M: int, rng) -> np.ndarray:
    """[K, M] 0/1 alleles.  Each site is polymorphic: its count of 1
    alleles i (1 <= i <= K - 1) is drawn from the neutral spectrum with the
    ancestral allele unknown, P(i) proportional to 1/i + 1/(K - i)
    (U-shaped), and the i carriers are drawn uniformly."""
    i = np.arange(1, K)
    p = 1.0 / i + 1.0 / (K - i)
    counts = rng.choice(i, size=M, p=p / p.sum())
    panel = np.zeros((K, M), dtype=np.int64)
    for m, c in enumerate(counts):
        panel[rng.choice(K, size=c, replace=False), m] = 1
    return panel


def li_stephens_model(K: int = 500, M: int = 256, seed: int = 0,
                      Ne: float = 20000.0, cm_per_mb: float = 1.0,
                      mean_spacing_bp: float = 1000.0):
    """(factors, sizes, values) of the Li-Stephens HMM over M sites and K
    templates: a uniform prior on ``x0``, the transitions
    [``x{m-1}``, ``x{m}``] and the emissions [``x{m}``, ``y{m}``].

    From ``seed``: the panel (:func:`panel_alleles`) and the site spacing
    (exponential, mean ``mean_spacing_bp``), on a constant map of
    ``cm_per_mb`` centimorgans a megabase.  Every site carries its allele
    leaf; which of them a query observes (the typed sites) is the
    evidence's business (:func:`typed_sites`)."""
    rng = np.random.default_rng(seed)
    panel = panel_alleles(K, M, rng)
    spacing = rng.exponential(mean_spacing_bp, size=M - 1)
    rho = 4.0 * Ne * (cm_per_mb * 1e-8) * spacing
    theta = mutation_rate(K)
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


def typed_sites(M: int, typed_every: int = 10):
    """Labels of the typed sites' allele leaves: one site in
    ``typed_every``, from the first."""
    return [f"y{m}" for m in range(0, M, typed_every)]
