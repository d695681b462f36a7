"""Framework configuration (counterpart of ``junctiontree_tpu/config.py``).

Only the knobs the PyTorch port reads are kept; the JAX package's XLA
settings (compile cache, mask donation, grouped thresholds, cold start) have
no meaning here."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # 'auto' heuristic: when greedy min-fill lands a clique above this many
    # states, escalate to a 16-restart randomized portfolio (then annealing)
    # and keep the better triangulation — the same rule as the JAX package,
    # so both packages compile identical plans
    escalate_min_states: int = 1 << 20

    # clique state-space size at which a batched contraction is routed
    # through the factored big-clique contraction (the hand-written CUDA
    # kernel on the card; counterpart of the JAX ``pallas_min_states``)
    big_clique_min_states: int = 1 << 17

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


DEFAULT = Config()
