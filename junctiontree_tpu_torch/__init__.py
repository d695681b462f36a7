"""junctiontree_tpu_torch — the PyTorch/CUDA port of ``junctiontree_tpu``.

Exact inference on discrete factor graphs by the junction-tree algorithm,
run with PyTorch on a CPU or an NVIDIA GPU.  The JAX package
``junctiontree_tpu`` stays the reference: both compile identical plans,
and the port is tested against it on the same plan and the same evidence.
This package imports torch and numpy, never JAX.

The host-side compile layer (``labels``, ``triangulate``, ``treebuild``,
``schedule``, ``models``) is a copy of the JAX package's, because importing
any module of ``junctiontree_tpu`` imports JAX.

Quick start:

    import junctiontree_tpu_torch as jt

    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cuda").set_potentials(values)
    posteriors, logz = eng.posterior_batch(jt.batch_masks_sparse(tree.plan, evidence_batch))
"""

from .api import CliqueGraph, FactorGraph, JunctionTree, create_junction_tree
from .config import DEFAULT, Config
from .convert import engine_from_numpy
from .evidence import batch_masks, batch_masks_sparse, random_evidence_batch
from .executor import Engine, batched_propagate_program, evidence_to_masks
from .ops.factored_contract import (
    big_clique_sep_message,
    factored_masked_contract,
    reference_factored_contract,
)
from .ops.semirings import SEMIRINGS, SUM_PRODUCT
from .schedule import Plan, compile_plan, load_plan, plan_from_json

__version__ = "0.1.0"

__all__ = [
    "create_junction_tree",
    "FactorGraph",
    "CliqueGraph",
    "JunctionTree",
    "Engine",
    "Config",
    "DEFAULT",
    "Plan",
    "compile_plan",
    "plan_from_json",
    "load_plan",
    "engine_from_numpy",
    "batch_masks",
    "batch_masks_sparse",
    "random_evidence_batch",
    "evidence_to_masks",
    "batched_propagate_program",
    "big_clique_sep_message",
    "factored_masked_contract",
    "reference_factored_contract",
    "SUM_PRODUCT",
    "SEMIRINGS",
    "__version__",
]
