"""The classic cloudy/sprinkler/rain/wet-grass Bayes net.

Role of the reference README's worked example (reference README.md:85-178)
— same graph shape (prior + three CPDs, binary vars, deterministic rows in the
wet-grass CPD exercising structural zeros).  CPT numbers are the standard
Pearl/Russell-Norvig sprinkler parameterization."""

from __future__ import annotations

import numpy as np


def sprinkler_model():
    """Returns (factors, sizes, values).

    Factors (state 0 = False, 1 = True):
      P(cloudy), P(sprinkler|cloudy), P(rain|cloudy),
      P(wet_grass|sprinkler, rain).
    """
    factors = [
        ["cloudy"],
        ["cloudy", "sprinkler"],
        ["cloudy", "rain"],
        ["sprinkler", "rain", "wet_grass"],
    ]
    sizes = {"cloudy": 2, "sprinkler": 2, "rain": 2, "wet_grass": 2}
    values = [
        np.array([0.5, 0.5]),
        # P(sprinkler|cloudy): rows cloudy=F,T
        np.array([[0.5, 0.5], [0.9, 0.1]]),
        # P(rain|cloudy)
        np.array([[0.8, 0.2], [0.2, 0.8]]),
        # P(wet|sprinkler, rain)
        np.array(
            [
                [[1.0, 0.0], [0.1, 0.9]],
                [[0.1, 0.9], [0.01, 0.99]],
            ]
        ),
    ]
    return factors, sizes, values
