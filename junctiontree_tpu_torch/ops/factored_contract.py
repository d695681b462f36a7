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
shared memory, float32 FMAs for float32 inputs and tensor-core ``wgmma``
fed by the Tensor Memory Accelerator for bfloat16, with the ``w1`` sum
fused behind it.

:func:`reference_factored_contract` is the plain PyTorch version.  The
wrapper :func:`factored_masked_contract` uses it only for tensors that lie
on the CPU; for a CUDA tensor it launches the kernel or raises.
:func:`library_factored_contract` computes the same function as two library
products.  It is the yardstick ``ops/autotune.py`` times the kernel against;
no serving path calls it: :func:`big_clique_sep_message` launches the kernel
for every float32 and bfloat16 tensor on the card.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .semirings import SUM_PRODUCT, pinned_precision

# kernel constants; they must match csrc/factored_contract.cu
F32_NT = 128           # float32: threads per block, BM * BN = 64 * F32_NT
F32_BK, F32_NSTAGE = 16, 3        # r2 elements per step, cp.async stages
F32_BLOCKS_PER_SM = 2  # the float32 kernel's launch bounds
BF16_BM, BF16_BK = 128, 64  # bfloat16: rows per block, r2 per stage
BF16_RING_BYTES = 192 * 1024  # the bf16 block's TMA ring; one block an SM
BF16_MAX_CLUSTER = 8   # blocks of one cluster (the portable limit)
BY_N_MAX_C = 32        # widest separator whose columns are tiled as (r1, c)
MAX_GRID_X = 2**31 - 1
MAX_SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472  # of which the card reserves 1 KB for each block


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


def f32_smem_bytes(bn: int) -> int:
    """Shared memory of a float32 block with ``bn`` columns: the cp.async
    ring of padded w2 [BM, 16 + 4] and pot [16, bn] tiles, reused by the
    epilogue's [BM, bn + 1] tile of sums."""
    bm, bk = 64 * F32_NT // bn, F32_BK
    return max(F32_NSTAGE * (bm * (bk + 4) + bk * bn) * 4, bm * (bn + 1) * 4)


def bf16_stages(bn: int) -> int:
    """Stages of a bfloat16 block's TMA ring: w2 [128, 64] and pot [64, bn]
    tiles."""
    return BF16_RING_BYTES // (BF16_BM * BF16_BK * 2 + BF16_BK * bn * 2)


def bf16_smem_bytes(bn: int) -> int:
    """Shared memory of a bfloat16 block with ``bn`` columns: the ring
    (which the epilogue reuses), its mbarriers and 1 KB to align the ring
    for the 128-byte swizzle."""
    st = bf16_stages(bn)
    return st * (BF16_BM * BF16_BK * 2 + BF16_BK * bn * 2) + 16 * st + 1024


def launch_config(
    B: int, R1: int, R2: int, C: int, n_sm: int, bf16: bool = False,
    cluster_slots=None,
) -> dict:
    """Grid of the CUDA kernel.  A block owns ``bm`` batch rows by ``bn``
    columns (see :func:`tiles_by_n`) and one range of r2, ``k_per_split``
    long, walked in steps of ``bk``.  When the row and column tiles alone
    cannot fill the card, r2 is split across ``nsplit`` blocks.

    float32: ``bm * bn = 8192`` with ``bn`` the narrowest of 16, 32 and 64
    that holds the "n" tiling's N = R1*C columns (64 for wider N and for the
    "c" tiling), and r2 split until every SM holds ``blocks_per_sm`` blocks.
    Each of the ``nparts`` [B, C] partials (one per r2 range, and with the
    "n" tiling per column tile) is added by a second kernel in a fixed
    order.

    bfloat16: ``bm = 128``, ``bn`` 64 or 128 (the "n" tiling takes all of
    N <= 128 in one tile), and the ``nsplit`` r2 ranges of a tile are the
    blocks of one cluster, which add their partials in rank order; only
    several column tiles of the "n" tiling leave ``nparts = n_n`` partials
    for the second kernel.  ``nsplit`` is the largest cluster size (at most
    8) at which every tile's cluster is resident at once:
    ``cluster_slots(bn, by_n)`` gives the clusters of each size 1..8 that
    the card holds (the wrapper asks the card; by default ``n_sm // size``,
    as if they packed perfectly).  Block ``split`` of a cluster takes the r2
    steps ``split, split + nsplit, ...`` (``k_per_split`` is then the step,
    64), so that the cluster reads neighbouring pieces of the same w2 rows
    at once.

    ``grid`` blocks in all; ``smem_bytes`` is the block's shared memory."""
    by_n = tiles_by_n(C)
    ncols = R1 * C if by_n else C
    if bf16:
        bm, bk = BF16_BM, BF16_BK
        bn = 128 if by_n and ncols > 64 else 64
        smem = bf16_smem_bytes(bn)
        per_sm = 1
    else:
        bn = next((w for w in (16, 32) if by_n and ncols <= w), 64)
        bm, bk = 64 * F32_NT // bn, F32_BK
        smem = f32_smem_bytes(bn)
        per_sm = min(F32_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024))
    n_b = -(-B // bm)
    n_n = -(-ncols // bn)
    n_k = -(-R2 // bk)
    if bf16:
        slots = (cluster_slots(bn, by_n) if cluster_slots is not None else
                 [per_sm * n_sm // size
                  for size in range(1, BF16_MAX_CLUSTER + 1)])
        fit = [size for size in range(1, min(BF16_MAX_CLUSTER, n_k) + 1)
               if slots[size - 1] >= n_b * n_n]
        # block `split` of a cluster takes the r2 steps split, split +
        # nsplit, ...: k_per_split is the step
        nsplit, k_per_split = max(fit, default=1), bk
    else:
        want = max(1, min(n_k, per_sm * n_sm // (n_b * n_n)))  # one wave
        steps = -(-n_k // want)
        nsplit, k_per_split = -(-n_k // steps), steps * bk
    if bf16:
        nparts = n_n if by_n and n_n > 1 else 1
    else:
        nparts = nsplit * n_n if by_n else nsplit
    return dict(
        by_n=by_n, bf16=bf16, bm=bm, bn=bn, bk=bk, n_b=n_b, n_n=n_n,
        nsplit=nsplit, k_per_split=k_per_split, nparts=nparts, grid=n_b * n_n * nsplit,
        blocks_per_sm=per_sm, smem_bytes=smem,
    )


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cluster_slots(device: torch.device, bn: int, by_n: bool) -> Tuple[int, ...]:
    """Clusters of 1..8 blocks of the bf16 kernel (bn, by_n) that the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    from .cuda_build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        slots = tuple(lib.jt_bf16_max_clusters(bn, int(by_n), size)
                      for size in range(1, BF16_MAX_CLUSTER + 1))
    if min(slots) < 0:
        raise RuntimeError(
            "cudaOccupancyMaxActiveClusters failed: "
            + lib.jt_error_string(-min(slots)).decode())
    return slots


def _tma_rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A contiguous 2-D bf16 tensor as the bf16 kernel's tensor maps read
    it, and its row stride in elements: the tensor itself where its address
    is 16-byte aligned and its rows a multiple of 8 elements, else a copy
    into a zero-padded buffer with such rows (counted in
    ``factored_masked_contract.padded``)."""
    rows, n = (int(d) for d in t.shape)
    if t.data_ptr() % 16 == 0 and n % 8 == 0:
        return t, n
    ld = -(-n // 8) * 8
    buf = torch.zeros((rows, ld), dtype=t.dtype, device=t.device)
    buf[:, :n] = t
    factored_masked_contract.padded += 1
    return buf, ld


def _launch_kernel(
    pot: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, backward: bool = False
) -> torch.Tensor:
    """Check the operands and launch the CUDA kernel once (CUDA tensors
    only).  Returns the float32 [B, C] result; counts the launch."""
    if pot.dim() != 3 or w1.dim() != 2 or w2.dim() != 2:
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
    in_dtype = torch.bfloat16 if bf16 else torch.float32
    out = torch.empty((B, C), dtype=torch.float32, device=pot.device)
    if out.numel() == 0 or R1 == 0 or R2 == 0:
        return out.zero_()
    cfg = launch_config(B, R1, R2, C, _sm_count(pot.device), bf16,
                        functools.partial(_cluster_slots, pot.device))
    if (cfg["grid"] > MAX_GRID_X or R1 * C > MAX_GRID_X
            or bf16 and max(B, R2, R1 * C) > MAX_GRID_X):
        raise ValueError(
            f"shape (B={B}, R1={R1}, R2={R2}, C={C}) exceeds the kernel's "
            "32-bit block and column indices"
        )
    # no copy where the caller already has the dtype and layout the kernel reads
    pot = (pot.permute(1, 0, 2) if cfg["by_n"] else pot).to(in_dtype).contiguous()
    w2 = w2.to(in_dtype).contiguous()
    w1 = w1.to(torch.float32).contiguous()
    ncols = R1 * C if cfg["by_n"] else C
    if bf16:
        # TMA reads rows at 16-byte aligned addresses and strides
        pot, ld_pot = _tma_rows(pot.reshape(-1, ncols))
        w2, ld_w2 = _tma_rows(w2)
        vec_a = vec_b = False  # cp.async staging: the float32 kernel only
    else:
        ld_pot, ld_w2 = ncols, R2
        chunk = 4  # floats per 16-byte cp.async
        vec_a = w2.data_ptr() % 16 == 0 and R2 % chunk == 0
        vec_b = pot.data_ptr() % 16 == 0 and ncols % chunk == 0
    ws = (
        out if cfg["nparts"] == 1
        else torch.empty((cfg["nparts"], B, C), dtype=torch.float32,
                         device=pot.device)
    )
    from .cuda_build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(pot.device).cuda_stream
    with torch.cuda.device(pot.device):
        rc = lib.jt_factored_contract(
            pot.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(),
            ws.data_ptr(), int(bf16), int(cfg["by_n"]), B, R1, R2, C,
            cfg["bn"], cfg["n_b"], cfg["n_n"], cfg["nsplit"],
            cfg["k_per_split"], cfg["nparts"], int(vec_a), int(vec_b),
            ld_pot, ld_w2, stream,
        )
    if rc != 0:
        raise RuntimeError(
            "factored_contract kernel launch failed: "
            + lib.jt_error_string(rc).decode() + f" (code {rc})"
        )
    factored_masked_contract.launches += 1
    factored_masked_contract.launches_bf16 += int(bf16)
    factored_masked_contract.launches_backward += int(backward)
    return out


def _contract_on_device(pot, w1, w2, backward=False):
    """The contraction where the tensors lie: the kernel on the card, the
    plain version on the CPU (and on meta tensors)."""
    if pot.is_cuda:
        return _launch_kernel(pot, w1, w2, backward)
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
    def forward(ctx, pot, w1, w2):
        ctx.save_for_backward(pot, w1, w2)
        return _contract_on_device(pot, w1, w2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        pot, w1, w2 = ctx.saved_tensors

        def contract(p, a, b):
            return _contract_on_device(p, a, b, backward=True)

        return _contract_grads(contract, pot, w1, w2, g, ctx.needs_input_grad)


def factored_masked_contract(
    pot: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """out[b, c] = sum_{r1, r2} pot[r1, r2, c] * w1[b, r1] * w2[b, r2].

    pot: [R1, R2, C], w1: [B, R1], w2: [B, R2]; float32 or bfloat16 on the
    card (any bf16 input puts pot and w2 in bf16; w1 is read as f32; the
    accumulator and the [B, C] output are f32).  With C <= 32 the kernel
    reads pot as [R2, R1*C] rows: a pot that is a ``permute(1, 0, 2)`` view
    of a contiguous [R2, R1, C] tensor, as :func:`big_clique_sep_message`
    passes it, is used as it is, and any other is copied once.  CPU tensors
    take :func:`reference_factored_contract`.

    When an input requires a gradient the call goes through a
    ``torch.autograd.Function`` on every device: ``dw1`` and ``dw2`` are
    this contraction again on a permuted potential (on the card: the
    kernel), ``dpot`` is one matrix product (:func:`_contract_grads`).
    bfloat16 is a serving dtype: a bf16 input that requires a gradient
    raises.

    Each kernel launch adds one to ``factored_masked_contract.launches``;
    one with bf16 inputs also to ``.launches_bf16``, one made by a backward
    pass also to ``.launches_backward``.  ``.padded`` counts the bf16
    operands copied into an aligned buffer first (an address or row length
    that the Tensor Memory Accelerator cannot take)."""
    operands = (pot, w1, w2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        if any(t.dtype == torch.bfloat16 and t.requires_grad for t in operands):
            raise TypeError(
                "a bfloat16 input requires a gradient: bfloat16 is a storage "
                "dtype for serving; learn in float32 or float64"
            )
        return _FactoredContract.apply(pot, w1, w2)
    return _contract_on_device(pot, w1, w2)


factored_masked_contract.launches = 0
factored_masked_contract.launches_bf16 = 0
factored_masked_contract.launches_backward = 0
factored_masked_contract.padded = 0


def kernel_or_plain(
    pot: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """The contraction as the serving path runs it: the kernel for float32
    and bfloat16 on the card; the plain version for other dtypes there
    (float64 references), and, through the wrapper, off the card."""
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
    run the CUDA kernel; every other dtype, and all CPU tensors, run the
    plain version.  Each call adds one to ``big_clique_sep_message.calls``.
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
    else:
        g1_vars, g2_axes = [], rest
        R1, R2 = 1, R
        w1, w2 = ones(1), ones(R)
    # the one copy of the permuted potential lands in the layout the kernel
    # reads: [R2, R1, C] rows for a small separator, else [R1, R2, C]
    r2_first = tiles_by_n(C)
    r1_axes, r2_axes, c_axes = (
        [cset.index(v) for v in vs] for vs in (g1_vars, g2_axes, sset))
    if isinstance(pot, torch.Tensor):
        if r2_first:
            p3 = pot.permute(r2_axes + r1_axes + c_axes).reshape(
                R2, R1, C).permute(1, 0, 2)
        else:
            p3 = pot.permute(r1_axes + r2_axes + c_axes).reshape(R1, R2, C)
    else:
        p3 = pot.kernel_layout(r1_axes, r2_axes, c_axes, r2_first)

    big_clique_sep_message.calls += 1
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


big_clique_sep_message.calls = 0
