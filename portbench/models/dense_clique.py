"""One dense factor over n variables plus one unary factor each.

A frozen copy of the program's big-clique benchmark model
(``chip_smoke.big_clique_model``): values ``rng.random + offset`` from
``numpy.random.default_rng(model_seed)``, the dense factor in float32,
the unaries in float64."""

from __future__ import annotations

import numpy as np


def build(cfg: dict):
    """(factors, sizes, values) of the configuration ``cfg``."""
    n, card, off = cfg["variables"], cfg["card"], cfg["value_offset"]
    rng = np.random.default_rng(cfg["model_seed"])
    names = [f"v{i}" for i in range(n)]
    factors = [names[:]] + [[v] for v in names]
    sizes = {v: card for v in names}
    values = [rng.random((card,) * n).astype(np.float32) + off] + [
        rng.random(card) + off for _ in names
    ]
    return factors, sizes, values
