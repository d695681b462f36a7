"""Factored big-clique contraction: the message from one large clique to its
separator under batched evidence, without the batched clique tensor.

Counterpart of ``junctiontree_tpu/ops/pallas_contract.py``.  A clique
potential with S = R1*R2*C states and evidence factored into two batched
weight groups W1 [B, R1], W2 [B, R2] is contracted to the separator:

    out[b, c] = sum_{r1, r2} pot[r1, r2, c] * W1[b, r1] * W2[b, r2]

Any einsum pairing of the three operands materializes a [B, R1*R2]-,
[B, R1, C]- or [B, R2, C]-sized intermediate.  On the card this runs the
hand-written CUDA kernel ``csrc/factored_contract.cu`` (it replaces the
Pallas TPU kernel ``factored_masked_contract``,
``junctiontree_tpu/ops/pallas_contract.py:181-307``): a tiled product of
``w2`` with the potential whose [B, R1, C] result stays in registers and
shared memory, on tensor-core ``wgmma`` fed by the Tensor Memory
Accelerator (bfloat16 in one pass, float32 in six bf16 passes, as XLA runs
"highest" on the TPU, after a small kernel splits the float32 potential
into bf16 planes), with the ``w1`` sum fused behind it; float32 products of
at most 32 columns (the model shards) run plain f32 FMAs on the CUDA cores.
Where the r2 sum is split over several blocks, the last block of each
output tile adds their partials in a fixed order inside the same launch.

A serving path hands the kernel the engine's standing potential
(:class:`StandingLayout`): what the launch reads of it in one layout (the
float32 split's bf16 planes, or bfloat16 rows) is made on the first call
and kept beside the tensor (:func:`kept`), so later calls skip the
permute copy and the split.

:func:`reference_factored_contract` is the plain PyTorch version (and
:func:`reference_split_pot` that of the split).  The
wrapper :func:`factored_masked_contract` uses it only for tensors that lie
on the CPU; for a CUDA tensor it launches the kernel or raises.
:func:`library_factored_contract` computes the same function as two library
products.  It is the yardstick ``ops/autotune.py`` times the kernel against;
no serving path calls it: :func:`big_clique_sep_message` launches the kernel
for every float32 and bfloat16 tensor on the card.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..utils.timing import TIMERS
from .semirings import SUM_PRODUCT, pinned_precision

# kernel constants; they must match csrc/factored_contract.cu
TC_BM = 128            # rows per block: two consumer warpgroups of 64
BK = {"bf16": 64, "f32x6": 32, "f32x1": 32}  # r2 a stage: a 128-byte w2 row
PLANES = {"bf16": 1, "f32x6": 3, "f32x1": 1}  # bf16 planes of pot
RING_BYTES = {"bf16": 192 * 1024, "f32x6": 200 * 1024, "f32x1": 200 * 1024}
SRC_CODE = {"bf16": 0, "f32x6": 1, "f32x1": 2}  # jt_factored_contract's src
MAX_CLUSTER = 8        # blocks of one cluster (the portable limit)
BY_N_MAX_C = 32        # widest separator whose columns are tiled as (r1, c)
# float32 products of at most this many columns (the model shards) run on
# the CUDA cores (jt_factored_contract_fma), where they measured faster
FMA_MAX_N = 32
FMA_NT, FMA_BK, FMA_NSTAGE = 128, 16, 3  # threads, r2 a step, cp.async stages
FMA_BLOCKS_PER_SM = 2  # the narrow kernel's launch bounds
MAX_GRID_X = 2**31 - 1
MAX_SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472  # of which the card reserves 1 KB for each block
# the TPU kernel's precision argument: float32 in six bf16 passes, or one
PRECISIONS = ("highest", "default")


def reference_factored_contract(
    pot: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``einsum("rsc,br,bs->bc")`` accumulated in at least
    float32 (bf16 inputs are widened to f32; f64 inputs stay f64).  One
    matrix product ``w2 [B, R2] x pot [R2, R1*C]``, then the W1 scaling and a
    sum over r1, so it materializes [B, R1, C]."""
    dt = torch.promote_types(
        torch.promote_types(pot.dtype, w1.dtype),
        torch.promote_types(w2.dtype, torch.float32),
    )
    R1, R2, C = pot.shape
    B = w1.shape[0]
    with pinned_precision():
        t = w2.to(dt) @ pot.to(dt).permute(1, 0, 2).reshape(R2, R1 * C)
    return (t.reshape(B, R1, C) * w1.to(dt)[:, :, None]).sum(dim=1)


def _mm(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``a @ b`` accumulated and returned in ``dt``.  Two bfloat16 operands
    on the card are multiplied as they are, on cuBLAS's tensor cores with a
    float32 result (``out_dtype``); other operands are widened first."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 and dt == torch.float32:
        return torch.mm(a, b, out_dtype=dt)
    return a.to(dt) @ b.to(dt)


def library_factored_contract(
    pot: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """The same contraction as two library products: what
    ``ops/autotune.measure`` times the kernel against (the JAX package's
    routed XLA einsum).  The pair is chosen so that the
    intermediate is the smallest of [B, R2, C] (``w1`` first), [B, R1, C]
    (``w2`` first) and [B, R1, R2] (the weights' outer product first).  It
    accumulates in float32 and returns float32 for bfloat16 inputs; float64
    inputs stay float64."""
    R1, R2, C = (int(d) for d in pot.shape)
    B = int(w1.shape[0])
    dt = torch.promote_types(
        torch.promote_types(pot.dtype, w1.dtype),
        torch.promote_types(w2.dtype, torch.float32),
    )
    sizes = (B * R2 * C, B * R1 * C, B * R1 * R2)
    pick = sizes.index(min(sizes))
    with pinned_precision():
        if pick == 0:    # sum over r1 first: [B, R2, C], then over r2
            t = _mm(w1, pot.reshape(R1, R2 * C), dt).reshape(B, R2, C)
            return torch.bmm(w2.to(dt)[:, None, :], t)[:, 0]
        if pick == 1:    # sum over r2 first: [B, R1, C], then over r1
            t = _mm(w2, pot.permute(1, 0, 2).reshape(R2, R1 * C), dt)
            return torch.bmm(w1.to(dt)[:, None, :], t.reshape(B, R1, C))[:, 0]
        # the weights' outer product [B, R1 * R2], then one product with pot
        o = (w1.to(dt)[:, :, None] * w2.to(dt)[:, None, :]).reshape(B, R1 * R2)
        return o @ pot.to(dt).reshape(R1 * R2, C)


def tiles_by_n(C: int) -> bool:
    """Which of the kernel's two column tilings a separator of C states
    takes.  True ("n", C <= 32): the columns are n = (r1, c) and the kernel
    reads pot as [R2, R1*C] rows.  False ("c"): the columns are c, r1 is
    looped inside the block, and the kernel reads pot as [R1, R2, C]."""
    return C <= BY_N_MAX_C


def source(bf16: bool, precision: str = "highest", ncols: int = None) -> str:
    """Which kernel, and where its operands come from: "bf16" (bf16 ``w2``
    and ``pot``, one pass, whatever ``precision`` asks), "fma" (float32 with
    at most ``FMA_MAX_N`` columns: plain f32 FMAs, exact at either
    precision), "f32x6" (f32 ``w2`` split in registers and the three bf16
    planes of ``pot``: six passes, "highest") or "f32x1" (one pass,
    "default").  ``ncols`` is the "n" tiling's N = R1*C (None: the "c"
    tiling)."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}")
    if bf16:
        return "bf16"
    if ncols is not None and ncols <= FMA_MAX_N:
        return "fma"
    return "f32x6" if precision == "highest" else "f32x1"


def fma_smem_bytes(bn: int) -> int:
    """Shared memory of a narrow float32 block with ``bn`` columns: the
    cp.async ring of padded w2 [BM, 16 + 4] and pot [16, bn] tiles, reused
    by the epilogue's [BM, bn + 1] tile of sums."""
    bm = 64 * FMA_NT // bn
    return max(FMA_NSTAGE * (bm * (FMA_BK + 4) + FMA_BK * bn) * 4,
               bm * (bn + 1) * 4)


def _fma_config(B: int, R1: int, R2: int, C: int, n_sm: int) -> dict:
    """Grid of the narrow float32 kernel: a block of 128 threads owns
    ``bm = 8192 / bn`` rows by all N <= ``bn`` (16 or 32) columns, and r2
    is split into contiguous ranges (``k_per_split``, in steps of 16) until
    every SM holds as many blocks as fit; the ``nsplit`` [B, C] partials
    are added in a fixed order by the last block of each row tile."""
    bn = 16 if R1 * C <= 16 else 32
    bm = 64 * FMA_NT // bn
    smem = fma_smem_bytes(bn)
    per_sm = min(FMA_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024))
    n_b = -(-B // bm)
    n_k = -(-R2 // FMA_BK)
    want = max(1, min(n_k, per_sm * n_sm // n_b))  # one wave
    steps = -(-n_k // want)
    nsplit = -(-n_k // steps)
    return dict(
        by_n=True, bf16=False, src="fma", planes=0, bm=bm, bn=bn, bk=FMA_BK,
        stages=FMA_NSTAGE, n_b=n_b, n_n=1, nsplit=nsplit, kparts=1,
        k_per_split=steps * FMA_BK, nparts=nsplit, grid=n_b * nsplit,
        blocks_per_sm=per_sm, smem_bytes=smem,
    )


def stage_bytes(bn: int, src: str) -> int:
    """One stage of the block's TMA ring: the w2 tile [128 rows, 128 bytes]
    and, per bf16 plane of pot, ``bn // 64`` boxes [BK r2, 64 columns]."""
    return TC_BM * 128 + PLANES[src] * (bn // 64) * BK[src] * 128


def stages(bn: int, src: str) -> int:
    """Stages of the block's ring."""
    return RING_BYTES[src] // stage_bytes(bn, src)


def smem_bytes(bn: int, src: str) -> int:
    """Shared memory of a block with ``bn`` columns: the ring (which the
    epilogue reuses), its mbarriers and 1 KB to align the ring for the
    128-byte swizzle."""
    st = stages(bn, src)
    return st * stage_bytes(bn, src) + 16 * st + 1024


def launch_config(
    B: int, R1: int, R2: int, C: int, n_sm: int, bf16: bool = False,
    cluster_slots=None, precision: str = "highest",
) -> dict:
    """Grid of the CUDA kernel.  A block owns ``bm = 128`` batch rows by
    ``bn`` columns (see :func:`tiles_by_n`: 64, or 128 where the "n"
    tiling's N = R1*C exceeds 64; wider N takes several column tiles) and
    walks r2 in stages of ``bk`` (64 bf16 or 32 f32: one 128-byte row of
    w2) through a ring of ``stages``.  ``src`` (:func:`source`) names the
    operands: bf16, or f32 in six or one bf16 passes.

    r2 is split ``kparts * nsplit`` ways: the ``nsplit`` blocks of one
    cluster add their partials in rank order, and each of a tile's
    ``kparts`` clusters leaves a partial, as does each column tile of the
    "n" tiling (``nparts`` in all), which the last block of the output tile
    to finish adds in a fixed order.  Clusters are only as large as lets
    all of them be resident at once: ``cluster_slots(bn, by_n)`` gives the
    clusters of each size 1..8 that the card holds (the wrapper asks the
    card for the kernel of ``src``; by default ``n_sm // size``, as if they
    packed perfectly).  float32 splits r2 as many ways as make one wave of
    blocks (at most the r2 steps), taking of those the largest cluster;
    bfloat16 splits it over one cluster alone, the largest that fits
    (``kparts = 1``): on an H100 a second kernel's launch for the sum cost
    bf16 more than the SMs it left idle, and f32, whose stages take longer,
    less.  Block z of a tile's splits takes the r2 steps ``z, z + kparts *
    nsplit, ...`` (``k_per_split`` is the step, ``bk``), so that a cluster
    reads neighbouring pieces of the same w2 rows at once.

    ``grid`` blocks in all, one an SM: one a tile and split, but the "c"
    tiling without clusters (more tiles than SMs) runs one wave of
    ``n_sm`` blocks that walk the tiles in turn.  ``smem_bytes`` is the
    block's shared memory.

    A float32 product of at most ``FMA_MAX_N`` columns takes the narrow
    CUDA-core kernel instead (:func:`_fma_config`, ``src`` "fma")."""
    by_n = tiles_by_n(C)
    ncols = R1 * C if by_n else C
    src = source(bf16, precision, ncols if by_n else None)
    if src == "fma":
        return _fma_config(B, R1, R2, C, n_sm)
    bm, bk = TC_BM, BK[src]
    bn = 128 if by_n and ncols > 64 else 64
    n_b = -(-B // bm)
    n_n = -(-ncols // bn)
    n_k = -(-R2 // bk)
    tiles = n_b * n_n
    slots = (cluster_slots(bn, by_n) if cluster_slots is not None else
             [n_sm // size for size in range(1, MAX_CLUSTER + 1)])
    # splits that fill one wave (bf16: one cluster, as large as fits)
    want = max(1, min(n_k, n_sm // tiles if not bf16 else MAX_CLUSTER))
    # (blocks, cluster size) of each size whose clusters all fit at once
    fits = [(size * k, size) for size in range(1, MAX_CLUSTER + 1)
            for k in [min(want // size, slots[size - 1] // tiles,
                          1 if bf16 else want)] if k > 0]
    _, nsplit = max(fits, default=(1, 1))
    kparts = max(1, want // nsplit) if fits and not bf16 else 1
    grid = tiles * kparts * nsplit
    if not by_n and grid == tiles and tiles > n_sm:
        grid = n_sm  # one wave that walks the tiles
    return dict(
        by_n=by_n, bf16=bf16, src=src, planes=PLANES[src], bm=bm, bn=bn,
        bk=bk, stages=stages(bn, src), n_b=n_b, n_n=n_n, nsplit=nsplit,
        kparts=kparts, k_per_split=bk,
        nparts=kparts * (n_n if by_n else 1), grid=grid, blocks_per_sm=1,
        smem_bytes=smem_bytes(bn, src),
    )


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cluster_slots(device: torch.device, src: str, bn: int,
                   by_n: bool) -> Tuple[int, ...]:
    """Clusters of 1..8 blocks of the kernel (src, bn, by_n) that the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    from .cuda_build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        slots = tuple(lib.jt_max_clusters(SRC_CODE[src], bn, int(by_n), size)
                      for size in range(1, MAX_CLUSTER + 1))
    if min(slots) < 0:
        raise RuntimeError(
            "cudaOccupancyMaxActiveClusters failed: "
            + lib.jt_error_string(-min(slots)).decode())
    return slots


def _tma_rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A contiguous 2-D tensor as the kernel's tensor maps read it, and its
    row stride in elements: the tensor itself where its address is 16-byte
    aligned and its rows a multiple of 16 bytes, else a copy into a
    zero-padded buffer with such rows (counter
    ``factored_masked_contract.padded``)."""
    rows, n = (int(d) for d in t.shape)
    per = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and n % per == 0:
        return t, n
    ld = -(-n // per) * per
    buf = torch.zeros((rows, ld), dtype=t.dtype, device=t.device)
    buf[:, :n] = t
    TIMERS.add("factored_masked_contract.padded")
    return buf, ld


def reference_split_pot(pot: torch.Tensor, by_n: bool, bk: int,
                        planes: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's split of a float32 ``pot`` [R1, R2, C]:
    ``(planes [planes, rows, ld] bf16, exponents [boxes] int32)`` as
    ``jt_split_pot`` writes them.  Rows are r2 ("n" tiling, ``by_n``:
    columns n = (r1, c)) or (r1, r2) (columns c); ``ld`` pads the columns
    to 8.  Each box of ``bk`` rows (of one r1 in the "c" tiling) and 64
    columns is scaled by 2^-e, e the exponent of its largest |pot| (0 for
    zeros), and written hi, mid, lo (hi alone for ``planes = 1``) with
    round-to-nearest-even, so that hi + mid + lo = pot * 2^-e to f32's
    precision."""
    R1, R2, C = (int(d) for d in pot.shape)
    x = pot.float().permute(1, 0, 2).reshape(R2, R1 * C) if by_n else \
        pot.float().reshape(R1, R2, C)
    x = x.reshape(1 if by_n else R1, R2, -1)
    ncols = x.shape[2]
    ld = -(-ncols // 8) * 8
    n_k, ncb = -(-R2 // bk), -(-ncols // 64)
    pad = torch.zeros((x.shape[0], n_k * bk, ncb * 64), dtype=torch.float32,
                      device=pot.device)
    pad[:, :R2, :ncols] = x
    boxes = pad.reshape(x.shape[0], n_k, bk, ncb, 64).permute(0, 1, 3, 2, 4)
    m = boxes.abs().amax(dim=(3, 4))
    exps = torch.where(m > 0, torch.frexp(m)[1] - 1,
                       torch.zeros_like(m, dtype=torch.int32))
    k = -exps.long()
    h = torch.div(k, 2, rounding_mode="trunc")
    scale = (torch.exp2(h.double()) * torch.exp2((k - h).double())).float()
    y = (boxes * scale[..., None, None]).permute(0, 1, 3, 2, 4).reshape(
        x.shape[0], n_k * bk, ncb * 64)[:, :R2, :ld]
    parts = []
    for _ in range(planes):
        p = y.to(torch.bfloat16)
        parts.append(p)
        y = y - p.float()
    out = torch.stack(parts).reshape(planes, -1, ld)
    return out, exps.reshape(-1).to(torch.int32)


def _split_pot(lib, pot: torch.Tensor, cfg: dict, stream
               ) -> Tuple[torch.Tensor, int, int]:
    """Launch the split of the float32 ``pot`` (any strides) into the
    kernel's bf16 planes (hi, mid, lo; hi alone for one pass), in the layout
    of ``cfg``'s tiling with rows padded to 16 bytes, each box of ``bk``
    rows and 64 columns (what one pot box of a stage holds) scaled by the
    exponent of its largest |pot|.  Returns the buffer, its row stride and
    the address of the boxes' exponents (int32), which the buffer holds
    behind the planes.  Counter ``factored_masked_contract.splits``."""
    R1, R2, C = (int(d) for d in pot.shape)
    n, boxes, ld = _operand_elems(R1, R2, C, cfg)
    buf = torch.empty(n + 2 * boxes, dtype=torch.bfloat16, device=pot.device)
    exps = buf.data_ptr() + 2 * n  # 16-byte aligned: ld is a multiple of 8
    rc = lib.jt_split_pot(
        pot.data_ptr(), buf.data_ptr(), exps, cfg["planes"], int(cfg["by_n"]),
        R1, R2, C, *pot.stride(), ld, cfg["bk"], stream)
    if rc != 0:
        raise RuntimeError(
            "factored_contract split launch failed: "
            + lib.jt_error_string(rc).decode() + f" (code {rc})")
    TIMERS.add("factored_masked_contract.splits")
    return buf, ld, exps


def _operand_elems(R1: int, R2: int, C: int, cfg: dict
                   ) -> Tuple[int, int, int]:
    """bf16 elements of what the tensor-core launch reads of pot in
    ``cfg``'s tiling (the planes, or the bf16 rows), the boxes whose
    exponents follow the float32 planes (0 for bf16), and the row stride:
    rows of r2 ("n" tiling) or of (r1, r2), columns padded to 8."""
    rows, ncols = (R2, R1 * C) if cfg["by_n"] else (R1 * R2, C)
    ld = -(-ncols // 8) * 8
    if cfg["bf16"]:
        return rows * ld, 0, ld
    boxes = (1 if cfg["by_n"] else R1) * -(-R2 // cfg["bk"]) * -(-ncols // 64)
    return cfg["planes"] * rows * ld, boxes, ld


class Operand(NamedTuple):
    """What a tensor-core launch reads of pot: ``buf`` (float32: the bf16
    planes and, behind them, the boxes' exponents at address ``exps``;
    bfloat16: the rows) with row stride ``ld``.  A kept one also holds the
    ``stream`` it was made on and an event ``ready`` recorded there."""
    buf: torch.Tensor
    ld: int
    exps: Optional[int] = None
    stream: object = None
    ready: object = None


class StandingLayout:
    """A standing potential seen in one kernel layout: ``pot`` (a tensor in
    its clique's axis order, on the card, needing no gradient) with the
    axes ``r1``, ``r2`` and ``c`` grouped into the kernel's [R1, R2, C];
    ``r2_first`` stores it as [R2, R1, C] rows (the "n" tiling).  This is
    what :func:`big_clique_sep_message` hands the kernel for a tensor
    marked :func:`standing` (the engine's potentials): the operand the launch
    reads is made on the first call and kept beside ``pot`` (:func:`kept`,
    keyed on the layout and on what the launch reads: float32 planes per
    tiling and pass count, or bfloat16 rows).  ``tensor()`` is the [R1, R2,
    C] view, copied where the axes ask; the narrow float32 route and the
    plain version read it on every call."""

    requires_grad = False

    def __init__(self, pot: torch.Tensor, r1: Sequence[int],
                 r2: Sequence[int], c: Sequence[int], r2_first: bool):
        self.pot, self.r2_first = pot, bool(r2_first)
        self.axes = (tuple(r1), tuple(r2), tuple(c))
        self.key = self.axes + (self.r2_first,)
        self.shape = tuple(
            int(np.prod([pot.shape[a] for a in ax])) for ax in self.axes)
        self.dtype, self.device = pot.dtype, pot.device
        self.is_cuda = pot.is_cuda

    def tensor(self) -> torch.Tensor:
        r1, r2, c = (list(ax) for ax in self.axes)
        R1, R2, C = self.shape
        if self.r2_first:
            return self.pot.permute(r2 + r1 + c).reshape(R2, R1, C).permute(
                1, 0, 2)
        return self.pot.permute(r1 + r2 + c).reshape(R1, R2, C)


class _Kept:
    """What is kept beside one standing tensor: at most ``layouts``
    operands in ``ops`` ({key: (operand, ``misses`` when last used)}, least
    recently used first), for its ``version``; ``handed`` counts the
    route's contractions that handed the tensor over as a standing one."""

    __slots__ = ("layouts", "version", "misses", "ops", "handed")

    def __init__(self, layouts: int):
        self.layouts, self.version, self.misses = int(layouts), None, 0
        self.ops: OrderedDict = OrderedDict()
        self.handed = 0


# standing tensor -> _Kept
_KEPT = WeakIdKeyDictionary()


def standing(pot: torch.Tensor, layouts: int) -> None:
    """Mark ``pot`` as a standing potential, one that outlives the calls
    that read it (an engine's potentials): :func:`kept` then keeps at most
    ``layouts`` operands for it, the number of contractions one call routes
    to its clique (``Engine._kept_layouts``).  Nothing is kept for any other
    tensor, nor for an inference tensor (it has no version counter to tell
    an edit) or one that requires a gradient."""
    if not (pot.is_inference() or pot.requires_grad):
        _KEPT[pot] = _Kept(layouts)


def _entry(pot: torch.Tensor) -> Optional[_Kept]:
    """``pot``'s entry in :data:`_KEPT` with what it holds dropped if
    ``pot`` was edited since, or None where nothing may be kept."""
    if pot.is_inference() or pot.requires_grad:
        return None
    entry = _KEPT.get(pot)
    if entry is not None and entry.version != pot._version:
        entry.version = pot._version
        entry.ops.clear()
    return entry


def handed(pot: torch.Tensor) -> int:
    """How many contractions the route handed ``pot`` to the kernel's
    wrapper as a standing potential (on any device; ``Engine`` counts on
    meta tensors which cliques reach the kernel)."""
    entry = _KEPT.get(pot) if not pot.is_inference() else None
    return 0 if entry is None else entry.handed


def kept(pot: torch.Tensor, key, make):
    """``make()`` for the tensor ``pot`` and ``key``, made once and kept
    beside ``pot`` while it lives and is not edited, where ``pot`` is
    marked :func:`standing`; else made on every call.

    Keyed on the tensor object (a weak key: the entry dies with the
    tensor, and a later tensor at the same address never finds it) and on
    its ``_version``: an in-place edit, through any view, drops all that
    is kept for it.  Nothing is kept for a tensor that requires a gradient
    (the learning paths change theirs on every step).  At most the
    ``layouts`` keys given to :func:`standing`: once they are taken, the
    least recently used goes out for a new key only if more misses on
    ``pot`` than one call's ``layouts`` have passed since it was last used
    (the calls have moved on to other layouts, as under another evidence
    pattern); else the new operand serves its call alone.  So one call of
    another pattern between two of a steady one, or a call that needs a
    layout beyond a call's (a joint beside posteriors), makes its own
    operands and puts none of the steady call's out.  Counters
    ``kept.hits`` and ``kept.misses``, and the operands put out
    (``kept.evictions``); phase ``k1.split``, the time of making one for a
    standing tensor; notes ``kept`` (found or not) on the open span."""
    entry = _entry(pot)
    if entry is None:
        TIMERS.add("kept.misses")
        TIMERS.note(kept=False)
        return make()
    ops = entry.ops
    if key in ops:
        ops[key] = (ops[key][0], entry.misses)
        ops.move_to_end(key)
        TIMERS.add("kept.hits")
        TIMERS.note(kept=True)
        return ops[key][0]
    TIMERS.add("kept.misses")
    entry.misses += 1
    TIMERS.note(kept=False)
    with TIMERS.phase("k1.split"):
        value = make()
    if len(ops) >= entry.layouts:
        oldest = next(iter(ops))
        if entry.misses - ops[oldest][1] <= entry.layouts:
            return value
        del ops[oldest]
        TIMERS.add("kept.evictions")
    ops[key] = (value, entry.misses)
    return value


def kept_sizes(pot: torch.Tensor) -> List[int]:
    """Bytes of each :class:`Operand` kept beside ``pot`` now."""
    entry = _entry(pot)
    if entry is None:
        return []
    return [op.buf.numel() * op.buf.element_size()
            for op, _ in entry.ops.values()]


def layout_bytes_bound(shape: Sequence[int], dtype: torch.dtype) -> int:
    """The most bytes one kept operand of a potential of ``shape`` and
    ``dtype`` takes, over every grouping of its axes into [R1, R2, C] the
    route can ask for and both precisions: what :func:`_operand_elems`
    gives at the worst grouping.  Every such R1*C ("n" tiling, with C = 1
    at its widest) and C ("c" tiling, with R2 = 1, which has the most
    exponent boxes) is a product of some of the axes' sizes.  bfloat16
    rows of one column (Z with no evidence grouped into r1) take 8 times
    the potential's bytes, padded to 16-byte rows; float32 products that
    narrow run on the CUDA cores and keep nothing."""
    states = int(np.prod(shape))
    prods = {1}
    for k in shape:
        prods |= {n * int(k) for n in prods}
    bf16 = dtype == torch.bfloat16
    worst = 0
    for n in prods:
        groupings = [(n, states // n, 1, True)]
        if not tiles_by_n(n):
            groupings.append((states // n, 1, n, False))
        for R1, R2, C, by_n in groupings:
            for precision in PRECISIONS:
                src = source(bf16, precision, R1 * C if by_n else None)
                if src == "fma":
                    continue
                cfg = dict(by_n=by_n, bk=BK[src], planes=PLANES[src],
                           bf16=bf16)
                elems, boxes, _ = _operand_elems(R1, R2, C, cfg)
                worst = max(worst, 2 * elems + 4 * boxes)
    return worst


def _operand(lib, pot, cfg: dict, stream) -> Operand:
    """What the tensor-core launch reads of ``pot``, on ``stream`` (a
    ``torch.cuda.Stream``): the split of a float32 potential, the bf16 rows
    of a bfloat16 one (no copy where the tensor has the layout already).
    Made on every call for a tensor, kept for a :class:`StandingLayout`; a
    kept operand made on another stream is waited for on this one (an
    event, no host sync) and its memory marked in use by this stream."""
    def make(t: torch.Tensor) -> Operand:
        if not cfg["bf16"]:
            return Operand(*_split_pot(lib, t, cfg, stream.cuda_stream))
        ncols = t.shape[0] * t.shape[2] if cfg["by_n"] else t.shape[2]
        rows = (t.permute(1, 0, 2) if cfg["by_n"] else t).to(
            torch.bfloat16).contiguous()
        return Operand(*_tma_rows(rows.reshape(-1, ncols)))

    if not isinstance(pot, StandingLayout):
        return make(pot)

    def make_kept() -> Operand:
        op = make(pot.tensor())
        if op.buf.untyped_storage().data_ptr() == \
                pot.pot.untyped_storage().data_ptr():
            # the layout is the tensor's own: keep a copy, since a view
            # would keep the tensor alive with its entry
            op = op._replace(buf=op.buf.clone())
        ready = torch.cuda.Event()
        ready.record(stream)
        return op._replace(stream=stream, ready=ready)

    op = kept(pot.pot, _kept_key(pot, cfg), make_kept)
    if op.stream != stream:
        stream.wait_event(op.ready)
        op.buf.record_stream(stream)
    return op


def _kept_key(layout: StandingLayout, cfg: dict) -> tuple:
    """The key of what a launch of ``cfg`` reads of ``layout``: its axes,
    and the tiling, stage depth and bf16 planes (float32), or bf16 rows."""
    return layout.key + (cfg["src"], cfg["by_n"], cfg["bk"], cfg["planes"])


# (device index, stream) -> int32 counters of output tiles, left at zero
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tile_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for the kernel's output-tile counters on
    ``stream``: one buffer for each device and stream, zeroed once when it
    is made, so that two launches that may run at once never share
    counters.  A launch leaves them at zero (the last block of each tile
    resets its counter)."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=device)
    return buf


def _check_rc(lib, rc: int, device: torch.device, stream: int) -> None:
    """Raise on a failed launch.  Its tile counters are dropped (the next
    launch on the stream gets new zeros), so that a launch that stopped
    half way leaves no count behind."""
    if rc != 0:
        _COUNTERS.pop((device.index, stream), None)
        raise RuntimeError(
            "factored_contract kernel launch failed: "
            + lib.jt_error_string(rc).decode() + f" (code {rc})")


def _launch_kernel(
    pot, w1: torch.Tensor, w2: torch.Tensor,
    backward: bool = False, precision: str = "highest",
) -> torch.Tensor:
    """Check the operands and launch the CUDA kernel once (CUDA tensors
    only), after the split of a float32 ``pot`` (kept for a
    :class:`StandingLayout`).  Returns the float32 [B, C] result; counts
    the launch."""
    if len(pot.shape) != 3 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("expected pot [R1, R2, C], w1 [B, R1], w2 [B, R2]")
    R1, R2, C = (int(d) for d in pot.shape)
    B = int(w1.shape[0])
    if tuple(w1.shape) != (B, R1) or tuple(w2.shape) != (B, R2):
        raise ValueError(
            f"shape mismatch: pot {tuple(pot.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)}"
        )
    if not (w1.device == w2.device == pot.device):
        raise ValueError("pot, w1 and w2 must be on one device")
    dtypes = {pot.dtype, w1.dtype, w2.dtype}
    if not dtypes <= {torch.float32, torch.bfloat16}:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got {dtypes}")
    bf16 = torch.bfloat16 in dtypes
    src = source(bf16, precision, R1 * C if tiles_by_n(C) else None)
    out = torch.empty((B, C), dtype=torch.float32, device=pot.device)
    if out.numel() == 0 or R1 == 0 or R2 == 0:
        return out.zero_()
    cfg = launch_config(B, R1, R2, C, _sm_count(pot.device), bf16,
                        functools.partial(_cluster_slots, pot.device, src),
                        precision)
    if cfg["grid"] > MAX_GRID_X or max(B, R2, R1 * C) > MAX_GRID_X:
        raise ValueError(
            f"shape (B={B}, R1={R1}, R2={R2}, C={C}) exceeds the kernel's "
            "32-bit block and column indices"
        )
    from .cuda_build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(pot.device)
    if cfg["src"] == "fma":
        if isinstance(pot, StandingLayout):
            pot = pot.tensor()
        _launch_fma(lib, pot, w1, w2, out, cfg, stream.cuda_stream)
        _count_launch(False, backward)
        return out
    with torch.cuda.device(pot.device):
        op = _operand(lib, pot, cfg, stream)
        w2c, ld_w2 = _tma_rows(w2.to(torch.bfloat16 if bf16 else torch.float32)
                               .contiguous())
        w2 = _as_launched(w2, w2c)
        w1 = _as_launched(w1, w1.to(torch.float32).contiguous())
        tiles = cfg["n_b"] * (1 if cfg["by_n"] else cfg["n_n"])
        ws, counters = out, None
        if cfg["nparts"] > 1:
            ws = torch.empty((cfg["nparts"], B, C), dtype=torch.float32,
                             device=out.device)
            counters = _tile_counters(out.device, stream.cuda_stream, tiles)
        rc = lib.jt_factored_contract(
            op.buf.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(),
            ws.data_ptr(), None if counters is None else counters.data_ptr(),
            SRC_CODE[src], int(cfg["by_n"]), B, R1, R2, C, cfg["bn"],
            cfg["n_b"], cfg["n_n"], cfg["nsplit"], cfg["kparts"],
            cfg["grid"], cfg["nparts"], op.ld, ld_w2, op.exps,
            stream.cuda_stream,
        )
    _check_rc(lib, rc, out.device, stream.cuda_stream)
    _count_launch(bf16, backward)
    return out


def _count_launch(bf16: bool, backward: bool) -> None:
    """Count one kernel launch in ``factored_masked_contract.launches``
    and, where it applies, ``.launches_bf16`` and ``.launches_backward``."""
    TIMERS.add("factored_masked_contract.launches")
    TIMERS.add("factored_masked_contract.launches_bf16", int(bf16))
    TIMERS.add("factored_masked_contract.launches_backward", int(backward))


def _launch_fma(lib, pot, w1, w2, out, cfg, stream) -> None:
    """Launch the narrow float32 kernel: pot as contiguous [R2, R1*C] rows
    (no copy where the caller hands that layout), w2 staged in 16-byte
    chunks where its rows allow."""
    R1, R2, C = (int(d) for d in pot.shape)
    B = int(w1.shape[0])
    pot = pot.permute(1, 0, 2).to(torch.float32).contiguous()
    w2 = _as_launched(w2, w2.to(torch.float32).contiguous())
    w1 = _as_launched(w1, w1.to(torch.float32).contiguous())
    chunk = 4  # floats per 16-byte cp.async
    vec_a = w2.data_ptr() % 16 == 0 and R2 % chunk == 0
    vec_b = pot.data_ptr() % 16 == 0 and (R1 * C) % chunk == 0
    ws, counters = out, None
    if cfg["nsplit"] > 1:
        ws = torch.empty((cfg["nsplit"], B, C), dtype=torch.float32,
                         device=out.device)
        counters = _tile_counters(out.device, stream, cfg["n_b"])
    with torch.cuda.device(out.device):
        rc = lib.jt_factored_contract_fma(
            pot.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(),
            ws.data_ptr(), None if counters is None else counters.data_ptr(),
            B, R1, R2, C, cfg["bn"], cfg["n_b"], cfg["nsplit"],
            cfg["k_per_split"], int(vec_a), int(vec_b), stream)
    _check_rc(lib, rc, out.device, stream)


def _as_launched(handed: torch.Tensor, launched: torch.Tensor
                 ) -> torch.Tensor:
    """``launched``, a weight operand as the kernel reads it, counted in
    ``route.materialized_bytes`` where the wrapper copied ``handed`` to make
    it (another dtype, contiguous rows, an aligned buffer)."""
    if launched.data_ptr() != handed.data_ptr():
        TIMERS.add("route.materialized_bytes",
                   launched.numel() * launched.element_size())
    return launched


def _contract_on_device(pot, w1, w2, backward=False, precision="highest"):
    """The contraction where the tensors lie: the kernel on the card, the
    plain version on the CPU (and on meta tensors), exact at either
    precision there, as XLA computes on the CPU."""
    if pot.is_cuda:
        return _launch_kernel(pot, w1, w2, backward, precision)
    if isinstance(pot, StandingLayout):
        pot = pot.tensor()
    return reference_factored_contract(pot, w1, w2)


# rows of (w1 (x) g) held at once by the potential's gradient, in elements
DPOT_CHUNK_ELEMS = 1 << 26


def _contract_grads(contract, pot, w1, w2, g, needs=(True, True, True)):
    """Gradients of ``out = contract(pot, w1, w2)`` given ``g = dL/dout``
    [B, C], for the inputs ``needs`` names; the others come back ``None``.

    ``dw1`` and ``dw2`` are the same contraction on a permuted potential,
    with ``g`` in ``w1``'s place (the kernel reads ``w1`` in float32 and
    loops or tiles over its axis, and sums over ``w2``'s axis in its inner
    loop):

        dw1[b, r1] = sum_{c, r2} pot[r1, r2, c] g[b, c] w2[b, r2]
                   = contract(pot.permute(2, 1, 0), g, w2)
        dw2[b, r2] = sum_{c, r1} pot[r1, r2, c] g[b, c] w1[b, r1]
                   = contract(pot.permute(2, 0, 1), g, w1)

    (``dw2`` could also put ``g`` in ``w2``'s place, with an inner loop of
    only C elements; the card measured it slower, ``PERF.md``.)  The
    potential's gradient is not this contraction but one matrix product,

        dpot[r1, r2, c] = sum_b w1[b, r1] g[b, c] w2[b, r2]
                        = ((w1 (x) g) [B, R1*C])^T @ w2 [B, R2],

    taken over ranges of r1 so that ``w1 (x) g`` stays under
    ``DPOT_CHUNK_ELEMS`` elements."""
    R1, R2, C = (int(d) for d in pot.shape)
    B = int(w1.shape[0])
    dpot = dw1 = dw2 = None
    if needs[1]:
        dw1 = contract(pot.permute(2, 1, 0), g, w2).to(w1.dtype)
    if needs[2]:
        dw2 = contract(pot.permute(2, 0, 1), g, w1).to(w2.dtype)
    if needs[0]:
        dt = torch.promote_types(pot.dtype, g.dtype)
        step = max(1, DPOT_CHUNK_ELEMS // max(1, B * C))
        w2t = w2.to(dt)
        parts = []
        for lo in range(0, R1, step):
            wg = (w1[:, lo:lo + step, None].to(dt) * g[:, None, :].to(dt))
            n = wg.shape[1]
            with pinned_precision():
                prod = torch.matmul(wg.reshape(B, n * C).t(), w2t)
            parts.append(prod.reshape(n, C, R2))
        dpot = (parts[0] if len(parts) == 1 else torch.cat(parts))
        dpot = dpot.permute(0, 2, 1).to(pot.dtype)
    return dpot, dw1, dw2


def factored_contract_grads(
    pot: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the contraction's backward pass: ``(dpot, dw1, dw2)``
    for upstream ``g`` [B, C], from :func:`reference_factored_contract` and
    ``torch.matmul`` alone.  The tests and the card's comparison use it;
    the training path uses :class:`_FactoredContract`."""
    return _contract_grads(reference_factored_contract, pot, w1, w2, g)


class _FactoredContract(torch.autograd.Function):
    """The contraction with its gradient.  Forward and the two weight
    gradients run :func:`_contract_on_device` (on the card: the kernel, each
    launch counted, the backward ones also in ``.launches_backward``); a
    gradient that no input asks for is not computed."""

    @staticmethod
    def forward(ctx, pot, w1, w2, precision):
        ctx.save_for_backward(pot, w1, w2)
        ctx.precision = precision
        return _contract_on_device(pot, w1, w2, precision=precision)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        pot, w1, w2 = ctx.saved_tensors

        def contract(p, a, b):
            return _contract_on_device(p, a, b, True, ctx.precision)

        return _contract_grads(contract, pot, w1, w2, g,
                               ctx.needs_input_grad[:3]) + (None,)


def factored_masked_contract(
    pot: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
    precision: str = "highest",
) -> torch.Tensor:
    """out[b, c] = sum_{r1, r2} pot[r1, r2, c] * w1[b, r1] * w2[b, r2].

    pot: [R1, R2, C], w1: [B, R1], w2: [B, R2]; float32 or bfloat16 on the
    card (any bf16 input puts pot and w2 in bf16; w1 is read as f32; the
    accumulator and the [B, C] output are f32).  CPU tensors take
    :func:`reference_factored_contract`, exact at either precision.

    ``precision``, as the TPU kernel's: "highest" (the default) runs float32
    in six bf16 tensor-core passes, f32-accurate; "default" in one bf16
    pass with f32 accumulation (~1e-3 relative); any other string raises
    ``ValueError``.  bf16 inputs take one pass whatever is asked.  A
    float32 ``pot`` is first split into bf16 planes by a small kernel that
    reads it through its strides (no copy); a bf16 ``pot`` is read as
    [R2, R1*C] rows for C <= 32: a ``permute(1, 0, 2)`` view of a
    contiguous [R2, R1, C] tensor, as :func:`big_clique_sep_message` passes
    it, is used as it is, and any other is copied once.

    When an input requires a gradient the call goes through a
    ``torch.autograd.Function`` on every device: ``dw1`` and ``dw2`` are
    this contraction again on a permuted potential (on the card: the
    kernel), ``dpot`` is one matrix product (:func:`_contract_grads`).
    bfloat16 is a serving dtype: a bf16 input that requires a gradient
    raises.

    Each kernel launch adds one to the counter
    ``factored_masked_contract.launches`` (``utils.timing.TIMERS``); one
    with bf16 inputs also to ``.launches_bf16``, one made by a backward
    pass also to ``.launches_backward``.  ``.splits`` counts the float32
    potentials split into bf16 planes (one before each float32 launch on
    the tensor cores; none before a narrow one).
    ``.padded`` counts the ``w2`` and bf16 ``pot`` operands copied into an
    aligned buffer first (an address or row length that the Tensor Memory
    Accelerator cannot take).

    ``pot`` may also be a :class:`StandingLayout` (what
    :func:`big_clique_sep_message` hands over for a standing potential):
    then the split or the bf16 rows are made on the first call for that
    layout and kept (:func:`kept`; ``kept.hits`` counts the calls that
    found them), and ``.splits`` stays put on later calls."""
    source(False, precision)  # an unknown precision raises on every device
    operands = (pot, w1, w2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        if any(t.dtype == torch.bfloat16 and t.requires_grad for t in operands):
            raise TypeError(
                "a bfloat16 input requires a gradient: bfloat16 is a storage "
                "dtype for serving; learn in float32 or float64"
            )
        return _FactoredContract.apply(pot, w1, w2, precision)
    return _contract_on_device(pot, w1, w2, precision=precision)


def kernel_or_plain(pot, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The contraction as the serving path runs it: the kernel for float32
    and bfloat16 on the card (``pot`` a tensor or a
    :class:`StandingLayout`); the plain version for other dtypes there
    (float64 references), and, through the wrapper, off the card."""
    R1, R2, C = pot.shape
    with TIMERS.span("k1.launch", R1=R1, R2=R2, C=C, B=w1.shape[0],
                     dtype=pot.dtype, kept=None):
        if pot.is_cuda and pot.dtype not in (torch.float32, torch.bfloat16):
            return reference_factored_contract(pot, w1, w2)
        return factored_masked_contract(pot, w1, w2)


def build_weight_groups(
    masks: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, List[int], List[int]]:
    """Split per-variable mask vectors [B, K_v] into two balanced groups and
    outer-product each group into W1 [B, prod(K of group1)], W2 [B, ...].

    The group split balances log-state-space so both W tensors stay small
    (each ~ B * sqrt(R))."""
    if not masks:
        raise ValueError("need at least one mask")
    sizes = [int(m.shape[-1]) for m in masks]
    order = np.argsort(sizes)[::-1]
    g1: List[int] = []
    g2: List[int] = []
    s1 = s2 = 0.0
    for ix in order:
        if s1 <= s2:
            g1.append(int(ix))
            s1 += np.log(sizes[ix])
        else:
            g2.append(int(ix))
            s2 += np.log(sizes[ix])

    def outer(ixs: List[int]) -> torch.Tensor:
        if not ixs:
            m0 = masks[0]
            return torch.ones((m0.shape[0], 1), dtype=m0.dtype, device=m0.device)
        acc = masks[ixs[0]]
        for ix in ixs[1:]:
            acc = (acc[:, :, None] * masks[ix][:, None, :]).reshape(
                acc.shape[0], -1
            )
        return acc

    return outer(g1), outer(g2), g1, g2


_BATCH = -1  # local batch pseudo-label for einsum subscripts


def _contract_items(items, out_vars, B, sizes):
    """Product of batched items ([B, *shape] over vars) broadcast onto
    [B, *out_vars] — a small einsum (item scopes are separators/masks)."""
    ops = [t for _, t in items]
    ovs = [[_BATCH] + list(vs) for vs, _ in items]
    covered = {v for vs, _ in items for v in vs}
    missing = [v for v in out_vars if v not in covered]
    if missing:
        ops.append(torch.ones(
            tuple(sizes[v] for v in missing), dtype=ops[0].dtype,
            device=ops[0].device,
        ))
        ovs.append(list(missing))
    out = SUM_PRODUCT.contract(ops, ovs, [_BATCH] + list(out_vars))
    return out.reshape(B, -1)


def _group_items(items, sizes):
    """Partition batched items into two weight groups.

    Items sharing variables are merged into components (their product cannot
    be split across the two kernel operands); components are then balanced
    greedily by log-state-space so both group weights stay ~sqrt(R)-sized.
    Returns (g1_items, g1_vars, g2_items, g2_vars)."""
    parent = list(range(len(items)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    var_owner: dict = {}
    for i, (vs, _) in enumerate(items):
        for v in vs:
            if v in var_owner:
                parent[find(i)] = find(var_owner[v])
            else:
                var_owner[v] = i
    comps: List[List[int]] = []
    comp_vars: List[List[int]] = []
    root_ix: dict = {}
    for i, (vs, _) in enumerate(items):
        r = find(i)
        if r not in root_ix:
            root_ix[r] = len(comps)
            comps.append([])
            comp_vars.append([])
        ci = root_ix[r]
        comps[ci].append(i)
        for v in vs:
            if v not in comp_vars[ci]:
                comp_vars[ci].append(v)
    weights = [sum(np.log(sizes[v]) for v in cv) for cv in comp_vars]
    order = np.argsort(weights)[::-1]
    g1: List[int] = []
    g2: List[int] = []
    s1 = s2 = 0.0
    for ci in order:
        if s1 <= s2:
            g1.append(int(ci))
            s1 += weights[ci]
        else:
            g2.append(int(ci))
            s2 += weights[ci]
    g1_items = [items[i] for ci in g1 for i in comps[ci]]
    g1_vars = [v for ci in g1 for v in comp_vars[ci]]
    g2_items = [items[i] for ci in g2 for i in comps[ci]]
    g2_vars = [v for ci in g2 for v in comp_vars[ci]]
    return g1_items, g1_vars, g2_items, g2_vars


def big_clique_sep_message(
    pot: torch.Tensor,
    clique_vars: Sequence[int],
    masks: dict,
    sep_vars: Sequence[int],
    *,
    msgs: Sequence[Tuple[Sequence[int], torch.Tensor]] = (),
    contract_fn=None,
) -> torch.Tensor:
    """Collect/distribute message from a (large) clique to its separator
    under batched evidence masks and batched child messages.

    pot: unbatched clique potential, axes = clique_vars order; or, with
    ``contract_fn``, an object with ``shape``, ``dtype`` and
    ``kernel_layout(r1_axes, r2_axes, c_axes, r2_first)`` that hands
    ``contract_fn`` the potential in the kernel's layout
    (``parallel.tp.ShardedPotential``: blocks of R1 on the model devices,
    never the whole potential on one).
    masks: {var id: [B, size_v]} for observed vars (subset of clique_vars).
    msgs: batched multi-variable operands (child separator messages), each
    (vars, tensor [B, *shape]); every message's vars must lie entirely inside
    sep_vars or entirely outside (messages crossing the separator boundary
    can't be factored — callers use the einsum path instead).
    Masks/messages scoped inside sep_vars are applied post-contraction.

    ``contract_fn(p3 [R1, R2, C], w1 [B, R1], w2 [B, R2]) -> [B, C]``
    replaces the one kernel call (``parallel.tp.tp_contract_fn`` shards it
    over a mesh's model axis).  Otherwise f32 and bf16 tensors on the card
    run the CUDA kernel, a ``pot`` marked :func:`standing` as a
    :class:`StandingLayout` (what the launch reads of it is kept beside it
    per layout); every other dtype, and all CPU tensors, run the plain
    version.  Each call adds one to the counter
    ``big_clique_sep_message.calls``.
    Returns [B, *sep_shape]."""
    cset = list(clique_vars)
    sset = list(sep_vars)
    rest = [v for v in cset if v not in sset]
    rest_set = set(rest)
    sep_set = set(sset)
    sizes = {v: int(pot.shape[cset.index(v)]) for v in cset}
    R = int(np.prod([sizes[v] for v in rest])) if rest else 1
    C = int(np.prod([sizes[v] for v in sset])) if sset else 1
    sep_shape = tuple(sizes[v] for v in sset)

    # split batched operands into rest-scoped items (folded into the kernel
    # weight groups) and sep-scoped items (applied to the output)
    items: List[Tuple[Tuple[int, ...], torch.Tensor]] = []
    sep_items: List[Tuple[Tuple[int, ...], torch.Tensor]] = []
    for v in cset:
        if v in masks:
            t = ((v,), masks[v])
            (items if v in rest_set else sep_items).append(t)
    for vs, t in msgs:
        vs = tuple(vs)
        if all(v in rest_set for v in vs):
            items.append((vs, t))
        elif all(v in sep_set for v in vs):
            sep_items.append((vs, t))
        else:
            raise ValueError(
                f"message scope {vs} crosses the separator boundary"
            )
    if not (items or sep_items):
        raise ValueError("need at least one batched operand")
    B = int((items + sep_items)[0][1].shape[0])
    device = (items + sep_items)[0][1].device

    def ones(n):
        return torch.ones((B, n), dtype=pot.dtype, device=device)

    if items:
        g1_items, g1_vars, g2_items, g2_vars = _group_items(items, sizes)
        grouped = set(g1_vars) | set(g2_vars)
        un_vars = [v for v in rest if v not in grouped]
        g2_axes = g2_vars + un_vars
        R1 = int(np.prod([sizes[v] for v in g1_vars])) or 1
        R2 = int(np.prod([sizes[v] for v in g2_axes])) or 1
        w1 = _contract_items(g1_items, g1_vars, B, sizes) if g1_items else ones(1)
        w2 = _contract_items(g2_items, g2_vars, B, sizes) if g2_items else ones(1)
        if pot.dtype == torch.bfloat16:
            # bfloat16 storage: the kernel reads pot and w2 in bfloat16 (w1
            # in float32), so round w2 before it is expanded, not after
            w2 = w2.to(torch.bfloat16)
        # w2 broadcast over uncovered rest axes
        n_un = int(np.prod([sizes[v] for v in un_vars])) or 1
        if n_un > 1:
            w2 = w2[:, :, None].expand(B, w2.shape[1], n_un).reshape(B, -1)
            TIMERS.add("route.materialized_bytes",
                       w2.numel() * w2.element_size())
    else:
        g1_vars, g2_axes = [], rest
        R1, R2 = 1, R
        w1, w2 = ones(1), ones(R)
    # the one copy of the permuted potential lands in the layout the kernel
    # reads: [R2, R1, C] rows for a small separator, else [R1, R2, C]; for a
    # standing potential on the card what the kernel reads of that layout
    # is made once and kept (StandingLayout)
    r2_first = tiles_by_n(C)
    r1_axes, r2_axes, c_axes = (
        [cset.index(v) for v in vs] for vs in (g1_vars, g2_axes, sset))
    if isinstance(pot, torch.Tensor):
        p3 = StandingLayout(pot, r1_axes, r2_axes, c_axes, r2_first)
        if not (contract_fn is None and _hand_over(pot)):
            p3 = p3.tensor()
    else:
        p3 = pot.kernel_layout(r1_axes, r2_axes, c_axes, r2_first)

    TIMERS.add("big_clique_sep_message.calls")
    contract = kernel_or_plain if contract_fn is None else contract_fn
    out = contract(p3, w1, w2).reshape((B,) + sep_shape)

    # apply separator-scoped masks/messages elementwise on the output
    for vs, t in sep_items:
        shape = [B] + [1] * len(sset)
        for i, v in enumerate(vs):
            shape[1 + sset.index(v)] = t.shape[1 + i]
        axes_order = [0] + [1 + list(vs).index(v) for v in sset if v in vs]
        out = out * t.permute(axes_order).reshape(shape)
    return out


def _hand_over(pot: torch.Tensor) -> bool:
    """Whether the route hands ``pot`` to the kernel as a
    :class:`StandingLayout`: a float32 or bfloat16 tensor on the card
    marked :func:`standing` (an engine's potential; not a product the
    route made for this call), which is no inference tensor and needs no
    gradient.  Counts the hand-over (:func:`handed`) on any device."""
    entry = _entry(pot)
    if entry is None or pot.dtype not in (torch.float32, torch.bfloat16):
        return False
    entry.handed += 1
    return pot.is_cuda
