"""junctiontree_tpu_torch — the PyTorch/CUDA port of ``junctiontree_tpu``.

Exact inference on discrete factor graphs by the junction-tree algorithm,
run with PyTorch on an NVIDIA GPU (or, when asked, on the CPU).  The JAX package
``junctiontree_tpu`` stays the reference: both compile identical plans,
and the port is tested against it on the same plan and the same evidence.
This package imports torch and numpy, never JAX.

The host-side compile layer (``labels``, ``triangulate``, ``treebuild``,
``schedule``, ``models``) is a copy of the JAX package's, because importing
any module of ``junctiontree_tpu`` imports JAX.

Quick start:

    import junctiontree_tpu_torch as jt

    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine().set_potentials(values)   # CUDA device 0; device="cpu" for the CPU
    posteriors, logz = eng.posterior_batch(jt.batch_masks_sparse(tree.plan, evidence_batch))

``tree.engine("log_sum_exp")`` and ``tree.engine("max_product")`` serve in
log space; ``dtype=torch.bfloat16`` stores the sum-product serving program
in bfloat16; ``posterior_batch(..., chunk=N)`` bounds the step's memory.

Beyond posteriors the engine answers ``map_assignment(_batch)`` and
``top_k_assignments(_batch)``, ``entropy(_batch)``,
``joint_marginal(_batch)`` and ``mutual_information``; ``incremental``
opens a cached-collect session; ``multiply_factor`` edits a live engine and
``save`` / ``load`` checkpoint it (``surgery`` edits compiled plans).

Beside the engine (every entry point takes ``device=``, default CUDA device
0): ``learn`` fits potentials (``fit_mle``, ``fit_mle_missing``, ``fit_em``;
expected counts are gradients of logZ, and on a big-clique model the
gradient goes through the CUDA kernel), ``learn_chain.fit_mle_chain`` fits
long chains, ``sampling.engine_sample(engine, seed, n)`` draws exact
posterior samples, ``chow_liu(data)`` learns a tree structure,
``MarginalMapSolver`` / ``marginal_map`` / ``tree.marginal_map`` answer
Marginal MAP, ``CutsetEngine`` serves dense models by cutset conditioning,
and ``LoopyEngine`` runs loopy belief propagation on the raw factor graph.

Around them: ``python -m junctiontree_tpu_torch MODEL.uai --device cuda|cpu``
answers the UAI tasks (MAR, MPE, PR, MMAP); ``Config`` bundles the knobs
(``Config(...).engine(factors, sizes, values)``); the reference's module
surfaces live in ``construction``, ``computation`` and ``sum_product``;
``compile_plan`` uses the C++ compiler under ``native/`` (built with ``g++``
at first use) from 512 variables up; every big-clique contraction on the
card launches the kernel, and ``ops.autotune`` measures it against the
library per shape as a diagnostic; every float32 product runs at the
package's precision (``ops.semirings.set_matmul_precision``, default
"highest": TF32 off).

Across devices and processes (``parallel``): ``make_mesh`` builds a grid of
devices, ``Engine.shard_batch`` / ``shard_model`` / ``shard_sequence`` split
rows, oversized cliques (the kernel once per model shard) and long chains
over it, and ``parallel.forest``, ``parallel.batch`` and
``parallel.multihost`` follow the JAX package's ``parallel`` modules.
"""

from . import approx, cutset, learn, learn_chain, mmap, parallel, sampling, structure
from .api import CliqueGraph, FactorGraph, JunctionTree, create_junction_tree
from .approx import LoopyEngine
from .config import DEFAULT, Config
from .convert import (
    chain_params_from_numpy,
    chain_stack_from_numpy,
    cutset_engine_from_numpy,
    engine_from_numpy,
    fused_stacks_from_numpy,
    loopy_engine_from_numpy,
    session_from_numpy,
    thetas_from_numpy,
)
from .cutset import CutsetEngine, choose_cutset
from .evidence import (
    apply_evidence,
    batch_masks,
    batch_masks_sparse,
    random_evidence_batch,
    shrink_sizes,
)
from .executor import Engine, batched_propagate_program, evidence_to_masks
from .incremental import IncrementalSession
from .joint import mutual_information_from_joint, steiner_subtree
from .mmap import MarginalMapSolver, marginal_map
from .ops.factored_contract import (
    big_clique_sep_message,
    factored_masked_contract,
    reference_factored_contract,
)
from .ops.semirings import LOG_SUM_EXP, MAX_PRODUCT, SEMIRINGS, SUM_PRODUCT
from .schedule import Plan, compile_plan, load_plan, plan_from_json
from .structure import chow_liu
from .surgery import (
    add_factor,
    change_root,
    insert_sepset,
    merge_plans,
    merge_trees,
    remove_factor,
)

__version__ = "0.1.0"

__all__ = [
    "create_junction_tree",
    "FactorGraph",
    "CliqueGraph",
    "JunctionTree",
    "Engine",
    "LoopyEngine",
    "CutsetEngine",
    "choose_cutset",
    "chow_liu",
    "MarginalMapSolver",
    "marginal_map",
    "Config",
    "DEFAULT",
    "Plan",
    "compile_plan",
    "plan_from_json",
    "load_plan",
    "engine_from_numpy",
    "chain_stack_from_numpy",
    "fused_stacks_from_numpy",
    "session_from_numpy",
    "thetas_from_numpy",
    "chain_params_from_numpy",
    "cutset_engine_from_numpy",
    "loopy_engine_from_numpy",
    "IncrementalSession",
    "steiner_subtree",
    "mutual_information_from_joint",
    "add_factor",
    "remove_factor",
    "merge_plans",
    "merge_trees",
    "change_root",
    "insert_sepset",
    "apply_evidence",
    "shrink_sizes",
    "batch_masks",
    "batch_masks_sparse",
    "random_evidence_batch",
    "evidence_to_masks",
    "batched_propagate_program",
    "big_clique_sep_message",
    "factored_masked_contract",
    "reference_factored_contract",
    "SUM_PRODUCT",
    "LOG_SUM_EXP",
    "MAX_PRODUCT",
    "SEMIRINGS",
    "__version__",
]
