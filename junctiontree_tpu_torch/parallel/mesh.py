"""Device meshes (counterpart of ``junctiontree_tpu/parallel/mesh.py``).

The JAX package drives every device of a process from one Python process: a
``jax.sharding.Mesh`` is a grid of local devices, and a ``psum`` is a
reduction across them.  The port keeps that design, one controller per
process: a :class:`Mesh` is a 2-D grid of ``torch.device``s over the axes
``("batch", "model")``, each shard of work is issued to its device from this
process, and partial results are summed on one device in a fixed order
(:func:`psum`), so a sum is bitwise repeatable.  Processes join only through
``torch.distributed`` (``parallel/multihost.py``); a mesh whose batch axis
spans processes records their number in ``processes``.

The ``batch`` axis carries data parallelism (rows of an evidence batch); the
``model`` axis carries tensor parallelism of oversized cliques (shards of a
clique potential).  ``torch.distributed.DeviceMesh`` / ``DTensor`` are not
used: they need one process per device, and NCCL refuses two ranks on one
card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

BATCH_AXIS = "batch"
MODEL_AXIS = "model"


class Mesh:
    """A grid of ``torch.device``s, ``devices[i, j]`` at batch index ``i``
    and model index ``j``.

    ``shape`` is ``{"batch": n_batch * processes, "model": n_model}``, the
    global extent as in JAX; ``devices`` holds this process's devices only.
    A device may appear more than once: that is for testing (``["cpu"] *
    8``) and for one card (``[cuda:0] * 4``), where the shards run one after
    another on the same device."""

    axis_names: Tuple[str, str] = (BATCH_AXIS, MODEL_AXIS)

    def __init__(self, devices, processes: int = 1):
        shape = np.shape(devices)[:2]
        if len(shape) != 2 or 0 in shape:
            raise ValueError("a mesh needs a non-empty 2-D grid of devices")
        grid = np.empty(shape, dtype=object)
        for ix in np.ndindex(grid.shape):
            grid[ix] = torch.device(devices[ix[0]][ix[1]])
        self.devices = grid
        self.processes = int(processes)
        self.shape = {BATCH_AXIS: grid.shape[0] * self.processes,
                      MODEL_AXIS: grid.shape[1]}

    def local_devices(self, axis: str) -> List[torch.device]:
        """This process's devices along ``axis``: the first column for the
        batch axis, the first row for the model axis."""
        if axis == BATCH_AXIS:
            return list(self.devices[:, 0])
        if axis == MODEL_AXIS:
            return list(self.devices[0, :])
        raise ValueError(f"unknown mesh axis {axis!r}")

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]}"
                f", processes={self.processes})")


def local_cuda_devices() -> List[torch.device]:
    """Every CUDA device of this process; raises where there is none (no
    quiet fall to the CPU: pass ``devices=`` to build a CPU mesh)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh defaults to the local CUDA devices, and "
            "torch.cuda.is_available() is false; pass devices=[\"cpu\"] * n "
            "to build one on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_batch: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over the (batch, model) axes.  ``devices`` defaults to every
    local CUDA device (raises without one); ``n_batch`` defaults to all of
    them over ``n_model``.  ``devices`` may repeat a device, for tests and
    for one card (see :class:`Mesh`)."""
    devices = list(devices) if devices is not None else local_cuda_devices()
    if n_batch is None:
        n_batch = len(devices) // n_model
    if n_batch < 1 or n_model < 1 or n_batch * n_model > len(devices):
        raise ValueError(
            f"a ({n_batch}, {n_model}) mesh needs {n_batch * n_model} "
            f"devices, got {len(devices)}"
        )
    use = devices[: n_batch * n_model]
    return Mesh([use[i * n_model:(i + 1) * n_model] for i in range(n_batch)])


@dataclass(frozen=True)
class Sharding:
    """Where an array's axes lie on a mesh: ``spec[k]`` names the mesh axis
    that axis ``k`` is split over (``None``: not split); a short ``spec``
    leaves the remaining axes whole.  The port's stand-in for JAX's
    ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis sharding for [B, ...] arrays."""
    return Sharding(mesh, (BATCH_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def row_blocks(n_rows: int, n_blocks: int) -> List[slice]:
    """``n_blocks`` contiguous row ranges covering ``n_rows``, sizes differing
    by at most one (the first ones longer); empty ranges are dropped."""
    base, extra = divmod(n_rows, n_blocks)
    out, lo = [], 0
    for i in range(n_blocks):
        hi = lo + base + (i < extra)
        if hi > lo:
            out.append(slice(lo, hi))
        lo = hi
    return out


def psum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Sum of per-device partials on ``device``, added in the order given
    (bitwise repeatable).  The copies are issued without waiting."""
    out = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        out = out + p.to(device, non_blocking=True)
    return out
