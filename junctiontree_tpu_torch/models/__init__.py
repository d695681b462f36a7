from .bayesnet import (alarm_like, banded_bayesnet, hailfinder_like, insurance_like, random_bayesnet)
from .chain import chain_bn_model, star_bn_model
from .grid import grid_mrf_model
from .sprinkler import sprinkler_model

__all__ = [
    "sprinkler_model",
    "grid_mrf_model",
    "chain_bn_model",
    "star_bn_model",
    "random_bayesnet",
    "banded_bayesnet",
    "alarm_like",
    "insurance_like",
    "hailfinder_like",
]
