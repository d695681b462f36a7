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
shared memory, float32 FMAs for float32 inputs and tensor-core ``mma.sync``
for bfloat16, with the ``w1`` sum fused behind it.

:func:`reference_factored_contract` is the plain PyTorch version.  The
wrapper :func:`factored_masked_contract` uses it only for tensors that lie
on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .semirings import SUM_PRODUCT

# kernel tile constants; they must match csrc/factored_contract.cu
BM = 128      # batch rows per block
BN = 64       # columns per block
NSTAGE = 3    # shared-memory stages of the cp.async ring
BK_F32, BK_BF16 = 16, 32          # r2 elements per step
BY_N_MAX_C = BN // 2   # widest separator whose columns are tiled as (r1, c)
BLOCKS_PER_SM = 2      # blocks resident on an SM (the kernel's launch bounds)
MAX_GRID_X = 2**31 - 1
MAX_SMEM_PER_BLOCK = 232_448


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
    t = w2.to(dt) @ pot.to(dt).permute(1, 0, 2).reshape(R2, R1 * C)
    return (t.reshape(B, R1, C) * w1.to(dt)[:, :, None]).sum(dim=1)


def tiles_by_n(C: int) -> bool:
    """Which of the kernel's two column tilings a separator of C states
    takes.  True ("n", C <= 32): the columns are n = (r1, c), at least two
    r1 to a 64-column tile, and the kernel reads pot as [R2, R1*C] rows.
    False ("c"): the columns are c, r1 is looped inside the block, and the
    kernel reads pot as [R1, R2, C]."""
    return C <= BY_N_MAX_C


def launch_config(
    B: int, R1: int, R2: int, C: int, n_sm: int, bf16: bool = False
) -> dict:
    """Grid of the CUDA kernel.  A block owns ``BM`` batch rows by ``BN``
    columns (see :func:`tiles_by_n`) and one range of r2, ``k_per_split``
    long, walked in steps of ``bk``.  When the row and column tiles alone
    cannot fill the card, r2 is split across ``nsplit`` blocks.  Each of the
    ``nparts`` partial [B, C] sums (one per r2 range, and with the "n" tiling
    per column tile) is added by a second kernel in a fixed order:
    deterministic, no atomics.  ``grid`` blocks in all, numbered
    ``(split * n_n + column tile) * n_b + row tile``; ``smem_bytes`` is the
    block's shared memory."""
    by_n = tiles_by_n(C)
    bk = BK_BF16 if bf16 else BK_F32
    n_b = -(-B // BM)
    n_n = -(-(R1 * C if by_n else C) // BN)
    n_k = -(-R2 // bk)
    want = max(1, min(n_k, BLOCKS_PER_SM * n_sm // (n_b * n_n)))  # one wave
    steps = -(-n_k // want)
    nsplit = -(-n_k // steps)
    # padded w2 [BM, bk] and pot [bk, BN] tiles, as csrc/factored_contract.cu
    stage = (BM * (bk + 8) + bk * (BN + 8)) * 2 if bf16 \
        else (BM * (bk + 4) + bk * BN) * 4
    return dict(
        by_n=by_n, bk=bk, n_b=n_b, n_n=n_n, nsplit=nsplit,
        k_per_split=steps * bk, nparts=nsplit * n_n if by_n else nsplit,
        grid=n_b * n_n * nsplit,
        smem_bytes=max(NSTAGE * stage, BM * (BN + 1) * 4),
    )


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    take :func:`reference_factored_contract`.  Each kernel launch adds one
    to ``factored_masked_contract.launches``."""
    if not pot.is_cuda:
        return reference_factored_contract(pot, w1, w2)
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
    cfg = launch_config(B, R1, R2, C, _sm_count(pot.device), bf16)
    if cfg["grid"] > MAX_GRID_X or R1 * C > MAX_GRID_X:
        raise ValueError(
            f"shape (B={B}, R1={R1}, R2={R2}, C={C}) exceeds the kernel's "
            "32-bit block and column indices"
        )
    # no copy where the caller already has the dtype and layout the kernel reads
    pot = (pot.permute(1, 0, 2) if cfg["by_n"] else pot).to(in_dtype).contiguous()
    w2 = w2.to(in_dtype).contiguous()
    w1 = w1.to(torch.float32).contiguous()
    chunk = 16 // pot.element_size()  # elements per 16-byte cp.async
    ncols = R1 * C if cfg["by_n"] else C
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
            cfg["n_b"], cfg["n_n"], cfg["nsplit"], cfg["k_per_split"],
            cfg["nparts"], int(vec_a), int(vec_b), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "factored_contract kernel launch failed: "
            + lib.jt_error_string(rc).decode()
        )
    factored_masked_contract.launches += 1
    return out


factored_masked_contract.launches = 0


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
) -> torch.Tensor:
    """Collect/distribute message from a (large) clique to its separator
    under batched evidence masks and batched child messages.

    pot: unbatched clique potential, axes = clique_vars order.
    masks: {var id: [B, size_v]} for observed vars (subset of clique_vars).
    msgs: batched multi-variable operands (child separator messages), each
    (vars, tensor [B, *shape]); every message's vars must lie entirely inside
    sep_vars or entirely outside (messages crossing the separator boundary
    can't be factored — callers use the einsum path instead).
    Masks/messages scoped inside sep_vars are applied post-contraction.

    f32 and bf16 tensors on the card run the CUDA kernel; every other dtype,
    and all CPU tensors, run the plain version.  Each call adds one to
    ``big_clique_sep_message.calls``.  Returns [B, *sep_shape]."""
    cset = list(clique_vars)
    sset = list(sep_vars)
    rest = [v for v in cset if v not in sset]
    rest_set = set(rest)
    sep_set = set(sset)
    perm = [cset.index(v) for v in rest + sset]
    p = pot.permute(perm)
    R = int(np.prod([p.shape[i] for i in range(len(rest))])) if rest else 1
    C = int(np.prod(p.shape[len(rest):])) if sset else 1
    sep_shape = tuple(p.shape[len(rest):])
    sizes = {v: int(pot.shape[cset.index(v)]) for v in cset}

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

    def ones(n):
        return torch.ones((B, n), dtype=pot.dtype, device=pot.device)

    if items:
        g1_items, g1_vars, g2_items, g2_vars = _group_items(items, sizes)
        grouped = set(g1_vars) | set(g2_vars)
        un_vars = [v for v in rest if v not in grouped]
        g2_axes = g2_vars + un_vars
        R1 = int(np.prod([sizes[v] for v in g1_vars])) or 1
        R2 = int(np.prod([sizes[v] for v in g2_axes])) or 1
        w1 = _contract_items(g1_items, g1_vars, B, sizes) if g1_items else ones(1)
        w2 = _contract_items(g2_items, g2_vars, B, sizes) if g2_items else ones(1)
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
    order = g2_axes + g1_vars if r2_first else g1_vars + g2_axes
    p = p.permute(
        [rest.index(v) for v in order] + list(range(len(rest), p.dim()))
    )
    p3 = (
        p.reshape(R2, R1, C).permute(1, 0, 2) if r2_first
        else p.reshape(R1, R2, C)
    )

    big_clique_sep_message.calls += 1
    if p3.is_cuda and p3.dtype not in (torch.float32, torch.bfloat16):
        # the kernel takes f32 and bf16; other dtypes (f64 references) on
        # the card take the plain version
        out = reference_factored_contract(p3, w1, w2)
    else:
        out = factored_masked_contract(p3, w1, w2)
    out = out.reshape((B,) + sep_shape)

    # apply separator-scoped masks/messages elementwise on the output
    for vs, t in sep_items:
        shape = [B] + [1] * len(sset)
        for i, v in enumerate(vs):
            shape[1 + sset.index(v)] = t.shape[1 + i]
        axes_order = [0] + [1 + list(vs).index(v) for v in sset if v in vs]
        out = out * t.permute(axes_order).reshape(shape)
    return out


big_clique_sep_message.calls = 0
