"""Tensor parallelism: clique-axis sharding of oversized cliques
(counterpart of ``junctiontree_tpu/parallel/tp.py``).

A clique whose state space is too large for one device is split over the
``model`` axis of a mesh along the factored rest axis R1 of the big-clique
contraction

    out[b, c] = sum_{r1, r2} pot[r1, r2, c] * w1[b, r1] * w2[b, r2],

each device contracts its block of R1 with the same function as on one
device (the CUDA kernel for float32 and bfloat16 on the card, the plain
version elsewhere), and the partial [B, C] results are summed in a fixed
order (``mesh.psum``).  The batch axis may be split over the ``batch`` axis
at the same time (a 2-D mesh).

``Engine.shard_model`` stores such a clique as a :class:`ShardedPotential`:
flat shards over the model devices, and, for each layout a contraction asks
for, the R1 blocks of that layout cut from the host copy once and cached on
the devices, so the whole potential never lands on one device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.factored_contract import kernel_or_plain
from .mesh import MODEL_AXIS, Mesh, psum, row_blocks


class _TensorBlocks:
    """R1 blocks of a [R1, R2, C] tensor (R1 a multiple of ``n``), each
    moved to the device that contracts it."""

    def __init__(self, pot: torch.Tensor, n: int):
        self.pot, self.r = pot, pot.shape[0] // n

    def block(self, mesh: Mesh, i: int, j: int) -> torch.Tensor:
        rows = self.pot[j * self.r:(j + 1) * self.r]
        return rows.to(mesh.devices[i, j], non_blocking=True)


def _contract_blocks(mesh: Mesh, blocks, w1, w2, shard_batch: bool):
    """Each model shard j contracts its R1 block with its slice of ``w1``
    (zero-padded to ``blocks.r`` columns per shard) on ``devices[i, j]``;
    the partials of batch block i are summed on ``w1``'s device."""
    n_batch, n_model = mesh.devices.shape
    n_batch = n_batch if shard_batch else 1
    B, r = int(w1.shape[0]), blocks.r
    if B % n_batch:
        raise ValueError(
            f"a batch of {B} rows does not split over the {n_batch} devices "
            "of the batch axis")
    pad = n_model * r - int(w1.shape[1])
    if pad:
        w1 = torch.nn.functional.pad(w1, (0, pad))
    outs = []
    for i, rows in enumerate(row_blocks(B, n_batch)):
        parts = []
        for j in range(n_model):
            dev = mesh.devices[i, j]
            parts.append(kernel_or_plain(
                blocks.block(mesh, i, j),
                w1[rows, j * r:(j + 1) * r].to(dev, non_blocking=True),
                w2[rows].to(dev, non_blocking=True),
            ))
        outs.append(psum(parts, w1.device))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def sharded_factored_contract(
    mesh: Mesh,
    pot: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    *,
    shard_batch: bool = True,
) -> torch.Tensor:
    """out[b, c] = sum_{r1, r2} pot[r1, r2, c] * w1[b, r1] * w2[b, r2],
    with the r1 axis split over the mesh's ``model`` axis (and, with
    ``shard_batch``, the rows over its ``batch`` axis: B must then divide
    by the batch-axis size).

    pot: [R1, R2, C] with R1 a multiple of the model-axis size; w1: [B, R1],
    w2: [B, R2].  Each shard runs the kernel on the card (float32 and
    bfloat16) and the plain version on the CPU or for float64.  Returns
    [B, C] on ``w1``'s device."""
    n_model = mesh.shape[MODEL_AXIS]
    R1 = int(pot.shape[0])
    if R1 % n_model:
        raise ValueError(
            f"R1 = {R1} is not a multiple of the model-axis size {n_model}")
    return _contract_blocks(mesh, _TensorBlocks(pot, n_model), w1, w2,
                            shard_batch)


def tp_contract_fn(mesh: Mesh, *, shard_batch: bool = False):
    """``contract_fn`` for ``big_clique_sep_message``: the factored
    big-clique contraction sharded over the model axis.  A tensor's R1 is
    zero-padded up to a multiple of the model-axis size (the padding adds
    nothing to the sum); a :class:`ShardedPotential`'s layout arrives already
    cut into blocks.  This is how ``Engine.shard_model`` routes oversized
    cliques instead of refusing them in ``check_feasible``."""
    n_model = mesh.shape[MODEL_AXIS]

    def contract(p3, w1, w2):
        if not isinstance(p3, torch.Tensor):
            return _contract_blocks(mesh, p3, w1, w2, shard_batch)
        pad = (-int(p3.shape[0])) % n_model
        if pad:
            p3 = torch.nn.functional.pad(p3, (0, 0, 0, 0, 0, pad))
            w1 = torch.nn.functional.pad(w1, (0, pad))
        return sharded_factored_contract(
            mesh, p3, w1, w2, shard_batch=shard_batch)

    return contract


class ShardedPotential:
    """A clique potential stored flat-sharded over a mesh's model axis.

    ``shards[j]`` holds states ``[j S/n, (j+1) S/n)`` of the potential in
    clique-variable order on ``mesh.devices[0, j]``.  A contraction asks
    for the kernel's layout (``kernel_layout``): R1 blocks of at most
    ceil(R1/n) x R2 x C states, cut once per layout from the host copy
    ``host`` and cached on every device of the mesh rows it runs on
    (``n_rows``: the batch-axis size when the contraction also splits rows,
    else 1).  Unbatched messages that the route multiplies into the
    potential (``times``) are multiplied into each block where it lies.
    ``gather`` assembles the whole potential on ``device`` (the engine's),
    for the paths that read it whole; a program reads ``dtype`` and
    ``device`` as it would a tensor's."""

    def __init__(self, host: np.ndarray, mesh: Mesh, dtype: torch.dtype,
                 via: torch.dtype, device, n_rows: int = 1):
        n = mesh.shape[MODEL_AXIS]
        flat = np.asarray(host).reshape(-1)
        if flat.size % n:
            raise ValueError(
                f"{flat.size} states do not split over {n} model devices")
        k = flat.size // n
        self.host, self.mesh, self.dtype = np.asarray(host), mesh, dtype
        self.device = torch.device(device)
        self.shape = tuple(self.host.shape)
        self.shards = [
            torch.from_numpy(np.ascontiguousarray(flat[j * k:(j + 1) * k]))
            .to(via).to(device=dev, dtype=dtype)
            for j, dev in enumerate(mesh.local_devices(MODEL_AXIS))
        ]
        self._via, self._n_rows = via, n_rows
        self._blocks: Dict[tuple, torch.Tensor] = {}
        self.msgs: Tuple[Tuple[torch.Tensor, Tuple[int, ...]], ...] = ()

    def to(self, dtype: torch.dtype) -> "ShardedPotential":
        """The same potential stored in ``dtype`` (cut from the host copy
        through the same ``via`` dtype, as one device would round it)."""
        if dtype == self.dtype:
            return self
        return ShardedPotential(self.host, self.mesh, dtype, self._via,
                                self.device, self._n_rows)

    def times(self, msgs: Sequence[Tuple[torch.Tensor, Sequence[int]]]):
        """This potential with unbatched messages ``(tensor, clique axes)``
        multiplied in, lazily: block by block in ``kernel_layout``."""
        out = object.__new__(ShardedPotential)
        out.__dict__.update(self.__dict__)
        out.msgs = tuple((t, tuple(a)) for t, a in msgs)
        return out

    def gather(self) -> torch.Tensor:
        return torch.cat([s.to(self.device) for s in self.shards]).reshape(
            self.shape)

    def kernel_layout(self, r1_axes, r2_axes, c_axes, r2_first):
        return _LayoutBlocks(self, tuple(r1_axes), tuple(r2_axes),
                             tuple(c_axes), bool(r2_first))


class _LayoutBlocks:
    """The R1 blocks of one kernel layout of a :class:`ShardedPotential`:
    memory [R2, r, C] viewed as [r, R2, C] when ``r2_first`` (the kernel's
    rows for a small separator), else [r, R2, C]; the last block is padded
    with zero rows to r = ceil(R1 / n)."""

    def __init__(self, sp: ShardedPotential, r1, r2, c, r2_first):
        self.sp, self.axes, self.r2_first = sp, (r1, r2, c), r2_first
        shape = sp.shape
        self.R1, self.R2, self.C = (
            int(np.prod([shape[a] for a in ax])) for ax in self.axes)
        self.r = -(-self.R1 // sp.mesh.shape[MODEL_AXIS])

    def _mem_order(self) -> List[int]:
        r1, r2, c = self.axes
        return list(r2 + r1 + c) if self.r2_first else list(r1 + r2 + c)

    def _unflat(self) -> List[int]:
        """Block shape with the R2 and C axes unflattened."""
        shape = self.sp.shape
        r1, r2, c = self.axes
        s2, sc = [shape[a] for a in r2], [shape[a] for a in c]
        return s2 + [self.r] + sc if self.r2_first else [self.r] + s2 + sc

    def _rows(self, x, j: int, axis: int):
        """Rows [j r, (j+1) r) of R1 (axis ``axis``), zero-padded to r."""
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(j * self.r, (j + 1) * self.r)
        rows = x[tuple(idx)]
        short = self.r - rows.shape[axis]
        if not short:
            return rows
        if isinstance(rows, np.ndarray):
            width = [(0, 0)] * rows.ndim
            width[axis] = (0, short)
            return np.pad(rows, width)
        pad = [0, 0] * (rows.dim() - axis - 1) + [0, short]
        return torch.nn.functional.pad(rows, pad)

    def _cut(self):
        """Every block of this layout on every device that runs one."""
        sp = self.sp
        x = np.transpose(sp.host, self._mem_order())
        x = (x.reshape(self.R2, self.R1, self.C) if self.r2_first
             else x.reshape(self.R1, self.R2, self.C))
        for i in range(sp._n_rows):
            for j, dev in enumerate(sp.mesh.devices[i]):
                key = (self.axes, self.r2_first, str(dev), j)
                if key not in sp._blocks:
                    blk = self._rows(x, j, 1 if self.r2_first else 0)
                    sp._blocks[key] = (
                        torch.from_numpy(np.ascontiguousarray(blk))
                        .to(sp._via).to(device=dev, dtype=sp.dtype))

    def block(self, mesh: Mesh, i: int, j: int) -> torch.Tensor:
        sp = self.sp
        dev = mesh.devices[i, j]
        key = (self.axes, self.r2_first, str(dev), j)
        if key not in sp._blocks:
            self._cut()
        blk = sp._blocks[key]
        if sp.msgs:
            # as one device multiplies them: in at least float32, stored
            # in the potential's dtype
            prod = blk.reshape(self._unflat()).to(
                torch.promote_types(blk.dtype, torch.float32))
            for t, axes in sp.msgs:
                prod = prod * self._factor(t, axes, j, dev)
            blk = prod.to(sp.dtype).reshape(blk.shape)
        return blk.permute(1, 0, 2) if self.r2_first else blk

    def _factor(self, t: torch.Tensor, axes, j: int, dev) -> torch.Tensor:
        """Message ``t`` over clique ``axes`` as a factor that broadcasts
        against block j's unflattened memory shape (its rows of R1 only)."""
        shape = self.sp.shape
        r1 = self.axes[0]
        mem = self._mem_order()
        f = t.permute([axes.index(a) for a in mem if a in axes]).reshape(
            [shape[a] if a in axes else 1 for a in mem])
        f = f.to(device=dev, dtype=torch.promote_types(f.dtype, torch.float32))
        # the R1 axes expanded and flattened into one, cut to this block
        lead = len(self.axes[1]) if self.r2_first else 0
        n1 = len(r1)
        f = f.expand(*f.shape[:lead], *[shape[a] for a in r1],
                     *f.shape[lead + n1:])
        f = f.reshape(*f.shape[:lead], self.R1, *f.shape[lead + n1:])
        return self._rows(f, j, lead)
