"""Sharded batched-evidence inference, data parallelism (counterpart of
``junctiontree_tpu/parallel/batch.py``).

The rows of an evidence-mask batch are split over the devices of a mesh's
batch axis; each device runs the per-row query (``torch.vmap`` of the
parity path) on its rows against its own copy of the replicated potentials.
No device waits on another until a global aggregate is asked for: the
``make_sharded_query_shardmap`` variant sums the log-partition statistics
over the batch axis, and over processes when ``torch.distributed`` is
initialized (``parallel/multihost.py``)."""

from __future__ import annotations

from functools import partial

import torch

from ..executor import apply_masks, partition, propagate_cliques, var_marginals
from ..ops.semirings import SUM_PRODUCT, Semiring
from ..schedule import Plan
from .mesh import BATCH_AXIS, Mesh, psum, row_blocks


def _single_query(plan: Plan, semiring: Semiring, pots, masks):
    mpots = apply_masks(plan, pots, masks, semiring)
    beliefs, _ = propagate_cliques(plan, mpots, semiring)
    return var_marginals(plan, beliefs, semiring), partition(plan, beliefs, semiring)


def _local_blocks(plan: Plan, mesh: Mesh, semiring: Semiring, pots,
                  mask_batch):
    """Per device of the batch axis: (its rows' marginals, Z), computed on
    that device against its copy of ``pots``."""
    devs = mesh.local_devices(BATCH_AXIS)
    B = int(mask_batch[0].shape[0])
    if B % len(devs):
        raise ValueError(
            f"a batch of {B} rows does not split over the {len(devs)} "
            "devices of the batch axis")
    outs = []
    for dev, rows in zip(devs, row_blocks(B, len(devs))):
        local = [torch.as_tensor(p, device=dev) for p in pots]
        masks = [torch.as_tensor(m[rows], device=dev) for m in mask_batch]
        outs.append(torch.vmap(partial(_single_query, plan, semiring, local))(
            masks))
    return devs[0], outs


def make_sharded_query(plan: Plan, mesh: Mesh,
                       semiring: Semiring = SUM_PRODUCT):
    """A batched evidence query whose rows are split over ``mesh``'s batch
    axis.

    Returns ``fn(pots, mask_batch) -> (var_marginals [B, size_v] list,
    Z [B])`` where ``pots`` are the clique potentials (tensors or arrays,
    copied to each device) and ``mask_batch[v]`` is [B, size_v] for every
    variable id.  B must be divisible by the batch-axis size.  Results are
    concatenated on the axis's first device."""

    def fn(pots, mask_batch):
        first, outs = _local_blocks(plan, mesh, semiring, pots, mask_batch)
        margs = [torch.cat([o[0][v].to(first) for o in outs])
                 for v in range(plan.num_vars)]
        return margs, torch.cat([o[1].to(first) for o in outs])

    return fn


def make_sharded_query_shardmap(plan: Plan, mesh: Mesh,
                                semiring: Semiring = SUM_PRODUCT):
    """Like :func:`make_sharded_query`, with an explicit collective: the
    mean log-partition over the whole batch, summed over the batch axis and,
    when ``torch.distributed`` is initialized, over every process (each
    passes its own rows).

    Returns ``fn(pots, mask_batch) -> (marginals, Z, global_mean_logZ)``;
    the marginals and Z are this process's rows."""

    def fn(pots, mask_batch):
        first, outs = _local_blocks(plan, mesh, semiring, pots, mask_batch)
        margs = [torch.cat([o[0][v].to(first) for o in outs])
                 for v in range(plan.num_vars)]
        z = torch.cat([o[1].to(first) for o in outs])
        sums = [(o[1] if semiring.is_log else torch.log(o[1])).sum()
                for o in outs]
        stats = torch.stack([
            psum(sums, first).to(torch.float64),
            torch.tensor(float(z.shape[0]), dtype=torch.float64, device=first),
        ])
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            # gloo reduces host tensors, NCCL tensors on this rank's card
            on = (torch.device("cuda", torch.cuda.current_device())
                  if torch.distributed.get_backend() == "nccl" else "cpu")
            stats = stats.to(on)
            torch.distributed.all_reduce(stats)
            stats = stats.to(first)
        return margs, z, (stats[0] / stats[1]).to(z.dtype)

    return fn
