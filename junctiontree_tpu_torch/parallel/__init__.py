"""Parallel inference over several devices and processes (counterpart of
``junctiontree_tpu/parallel``): ``mesh`` (the device grid), ``batch``
(sharded batched queries), ``tp`` (the factored big-clique contraction
sharded over the model axis), ``forest`` (independent components on separate
devices) and ``multihost`` (``torch.distributed`` bring-up)."""

from .mesh import (
    BATCH_AXIS,
    MODEL_AXIS,
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    replicated,
)

__all__ = [
    "BATCH_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "Sharding",
    "batch_sharding",
    "make_mesh",
    "replicated",
]
