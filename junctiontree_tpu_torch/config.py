"""Framework configuration (counterpart of ``junctiontree_tpu/config.py``).

Only the knobs the PyTorch port reads are kept; the JAX package's XLA
settings (compile cache, mask donation, grouped thresholds, cold start) have
no meaning here."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # numeric
    semiring: str = "sum_product"          # sum_product | log_sum_exp | max_product
    # float32 products of the package: "highest" (TF32 off, the default),
    # "high" or "default" (TF32 allowed); see ops.semirings.pinned_precision
    matmul_precision: str = "highest"

    # compile
    heuristic: str = "auto"                # auto (min_fill + escalation) |
    #                                        min_fill | min_degree |
    #                                        min_weight | portfolio[N] | anneal[S]
    backend: str = "auto"                  # auto | python | native (C++ compiler)
    root: Optional[int] = None             # clique to root the tree at

    # 'auto' heuristic: when greedy min-fill lands a clique above this many
    # states, escalate to a 16-restart randomized portfolio (then annealing)
    # and keep the better triangulation — the same rule as the JAX package,
    # so both packages compile identical plans
    escalate_min_states: int = 1 << 20

    # clique state-space size at which a batched contraction is routed
    # through the factored big-clique contraction (the hand-written CUDA
    # kernel on the card; counterpart of the JAX ``pallas_min_states``)
    big_clique_min_states: int = 1 << 17

    # tensor parallelism: clique state-space size from which an Engine with
    # a model mesh (Engine.shard_model) serves the clique split over the
    # mesh's model axis instead of on one device
    tp_min_states: int = 1 << 26

    # ops/autotune.decide times the kernel against two library products per
    # big-clique contraction shape on the card and caches the faster; off,
    # it answers "k1" without measuring.  A diagnostic: serving always
    # launches the kernel.  Read from DEFAULT; ops.autotune.set_enabled
    # writes it
    autotune: bool = True
    # directory of the measured decisions (autotune.json); None means
    # ~/.cache/junctiontree_tpu_torch
    autotune_cache_dir: Optional[str] = None

    # default ``dtype`` of an Engine when the caller passes none: "float32",
    # "float64", or "bfloat16" (storage of the rescaled sum-product serving
    # program only: potentials and messages sit in bfloat16,
    # contractions accumulate in float32, results are float32; the parity
    # paths and log-space engines stay float32)
    storage_dtype: str = "float32"

    # distribute-pass Hugin division trick (executor.divide_project): derive
    # each child's down-message from the clique belief by guarded division
    # instead of leave-one-out products, and reuse the belief for the
    # marginal phase.  Sum-product and log-sum-exp only, on cliques small
    # enough that their belief is materialized anyway.  Off by default, as
    # in the JAX package; read when a serving program is built.
    distribute_division: bool = False

    def apply(self) -> "Config":
        """Put the process-wide knob into effect: the package's matmul
        precision (``autotune`` and the rest are read where they act, from
        ``DEFAULT``)."""
        from .ops.semirings import set_matmul_precision

        set_matmul_precision(self.matmul_precision)
        return self

    # one-stop constructors honoring every knob
    def compile(self, factors, sizes):
        """``compile_plan`` with this config's heuristic, backend and root."""
        from .schedule import compile_plan

        self.apply()
        return compile_plan(
            factors, sizes,
            root=self.root, backend=self.backend, heuristic=self.heuristic,
        )

    def engine(self, factors, sizes, values=None, device=None):
        """Plan + Engine (with this config's semiring and storage dtype) on
        ``device`` (default CUDA device 0); ``values`` optional."""
        import torch

        from .executor import Engine
        from .ops.semirings import SEMIRINGS

        eng = Engine(
            self.compile(factors, sizes), SEMIRINGS[self.semiring],
            device=device, dtype=getattr(torch, self.storage_dtype),
        )
        if values is not None:
            eng.set_potentials(values)
        return eng


DEFAULT = Config()
