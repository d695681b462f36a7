"""Multi-process bring-up (counterpart of
``junctiontree_tpu/parallel/multihost.py``).

One controller per process, as in the JAX package: each process drives its
own devices, and processes join through ``torch.distributed``.  The recipe:

  1. every process calls :func:`initialize` with the coordinator's address,
     the number of processes and its own rank (or nothing, under a launcher
     that sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
     ``WORLD_SIZE``);
  2. :func:`make_multihost_mesh` builds the (batch, model) mesh: the model
     axis within a process's devices, the batch axis across processes;
  3. each process feeds its own rows (:func:`host_local_batch_to_global`
     says where they sit in the global batch) to the same programs, e.g.
     ``batch.make_sharded_query_shardmap``, whose global aggregate is an
     ``all_reduce`` over the processes.

The backend is gloo on the CPU and NCCL on cards, except where ranks would
share a card: NCCL refuses two ranks on one GPU, so those take gloo."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, local_cuda_devices


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group``, a no-op at one process or
    when a group exists already.

    ``coordinator_address`` is ``"host:port"`` (``init_method="tcp://..."``);
    with no arguments the launcher's environment is read
    (``init_method="env://"``).  ``backend`` defaults to NCCL when this host
    has a card for every process, else gloo; under NCCL rank ``process_id``
    takes card ``process_id % device_count`` as its current device."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = ("nccl" if num_processes is not None
                   and 0 < num_processes <= n_cards else "gloo")
    if backend == "nccl" and process_id is not None:
        # NCCL reduces on the current card: one card per rank
        torch.cuda.set_device(process_id % n_cards)
    if coordinator_address is None:
        dist.init_process_group(backend=backend, init_method="env://")
    else:
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
        )


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_multihost_mesh(n_model_per_host: int = 1,
                        devices: Optional[Sequence] = None) -> Mesh:
    """Global (batch, model) mesh: the model axis within this process's
    devices (``devices``, default every local CUDA device; raises without
    one), the batch axis over the rest of them and over every process."""
    local = list(devices) if devices is not None else local_cuda_devices()
    if n_model_per_host > len(local):
        raise ValueError(
            f"n_model_per_host={n_model_per_host} exceeds the {len(local)} "
            "local devices")
    n_batch = len(local) // n_model_per_host
    grid = [local[i * n_model_per_host:(i + 1) * n_model_per_host]
            for i in range(n_batch)]
    return Mesh(grid, processes=_process_count())


class LocalBatch(NamedTuple):
    """This process's rows of a global batch: ``arrays`` (its local row
    blocks, as tensors), the global index of its first row (``offset``) and
    the global batch size (``total``)."""

    arrays: list
    offset: int
    total: int


def host_local_batch_to_global(mesh: Mesh, local_arrays) -> LocalBatch:
    """Place this process's rows in the global batch: an ``all_gather`` of
    every process's row count gives its offset and the total; no mask data
    moves (each process serves its own rows on ``mesh``, which the JAX
    package's signature names; the port needs nothing of it here)."""
    arrays = [torch.as_tensor(np.asarray(a)) for a in local_arrays]
    n = int(arrays[0].shape[0]) if arrays else 0
    if any(int(a.shape[0]) != n for a in arrays):
        raise ValueError("local arrays differ in their number of rows")
    counts = [n]
    if dist.is_initialized():
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, n)
        offset = sum(counts[:dist.get_rank()])
    else:
        offset = 0
    return LocalBatch(arrays, offset, sum(counts))


def scaling_report(qps_per_config: dict) -> dict:
    """Scaling-efficiency table.

    Input {config_name: (n_chips, qps)}; output adds per-config efficiency
    relative to linear scaling from the config with the fewest chips."""
    if not qps_per_config:
        return {}
    items = sorted(qps_per_config.items(), key=lambda kv: kv[1][0])
    base_n, base_qps = items[0][1]
    out = {}
    for name, (n, qps) in items:
        ideal = base_qps * (n / base_n)
        out[name] = {
            "chips": n,
            "qps": qps,
            "efficiency": qps / ideal if ideal else 0.0,
        }
    return out
