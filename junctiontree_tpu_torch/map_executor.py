"""Exact batched MAP and k-best decoding on arbitrary junction trees
(counterpart of ``junctiontree_tpu/map_executor.py``).

Max-product collect pass with argmax backpointers, then a downward
traceback, over an evidence-mask batch.  This is the general-tree
counterpart of the chain Viterbi program (``scan_executor.py``).  Traceback
picks a *consistent* joint argmax by construction, so ties are harmless:
whichever of several equal maxima ``torch.max`` / ``torch.topk`` reports,
the backpointer stored with it names the completion that scores it.  (The
JAX package takes the lowest index among equals; torch promises the first
maximum for ``max`` and no order for ``topk``, so assignments may differ
between the packages on tied models while scores do not.)

The running-intersection property guarantees each variable is decoded
exactly once: a variable not in a clique's parent separator cannot have been
assigned earlier in the pre-order traversal.

Programs are plain functions on tensors, ``fn(log_pots, masks) -> (assign,
score)``; ``assign`` is ``torch.int32`` (torch's own ``argmax``, ``topk``
and ``gather`` speak int64, which stays inside).  Backpointers are stored as
int32: there is one [B, sep_states] tensor per clique, alive until the
traceback.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .executor import clique_mask_vars
from .schedule import Plan
from .utils.timing import TIMERS

_NEG = -1e30  # -inf stand-in: a forbidden state scores about -1e30, never NaN


def _strides(shape) -> List[int]:
    st = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        st[i] = st[i + 1] * shape[i + 1]
    return st


class _Decoder:
    """Index tensors that turn a flat state index over ``vs`` (row-major,
    extents from ``sizes``) into per-variable states, and back: all of a
    scope's variables are decoded with one divide and one modulo."""

    def __init__(self, vs: Sequence[int], sizes: Sequence[int]):
        self.vs = list(vs)
        self.shape = [sizes[v] for v in self.vs]
        self._consts: Dict[torch.device, tuple] = {}

    def consts(self, device):
        c = self._consts.get(device)
        if c is None:
            def t(xs):
                return torch.tensor(xs, dtype=torch.int64, device=device)

            c = (t(self.vs), t(_strides(self.shape)), t(self.shape))
            self._consts[device] = c
        return c

    def write(self, assign: torch.Tensor, flat: torch.Tensor) -> None:
        """assign[..., vs] = states of the flat index ``flat`` [...]."""
        if not self.vs:
            return
        ids, strides, shape = self.consts(assign.device)
        assign[..., ids] = ((flat.unsqueeze(-1) // strides) % shape).to(assign.dtype)

    def flat(self, assign: torch.Tensor) -> torch.Tensor:
        """Flat int64 index [...] of the states ``assign[..., vs]``."""
        ids, strides, _ = self.consts(assign.device)
        return (assign[..., ids].to(torch.int64) * strides).sum(dim=-1)


def _layout(plan: Plan):
    """Per non-root clique: axes permuted to (sep..., rest...), the two
    state counts, and decoders for the separator, the rest and the clique."""
    tree, cvars, svars = plan.tree, plan.clique_vars, plan.sep_vars
    layout = {}
    for c in tree.topo_order[1:]:
        sep = list(svars[tree.parent_sep[c]])
        rest = [v for v in cvars[c] if v not in sep]
        perm = [cvars[c].index(v) for v in sep + rest]
        sep_shape = tuple(plan.sizes[v] for v in sep)
        sepN = int(np.prod(sep_shape)) if sep_shape else 1
        restN = int(np.prod([plan.sizes[v] for v in rest])) if rest else 1
        layout[c] = (
            perm, sep_shape, sepN, restN,
            _Decoder(sep, plan.sizes), _Decoder(rest, plan.sizes),
        )
    return layout


def _add(bel: torch.Tensor, x: torch.Tensor, owned: bool) -> torch.Tensor:
    """bel + x (x broadcasts into bel's clique shape); in place once ``bel``
    is a tensor of this program's own with the batch extent of the sum, so
    that a [B, clique_states] tensor is not alive twice per operand.  A new
    tensor counts in ``map.materialized_bytes``."""
    if owned and bel.shape[0] >= x.shape[0]:
        return bel.add_(x)
    out = bel + x
    TIMERS.add("map.materialized_bytes", out.numel() * out.element_size())
    return out


def _masked_potential(plan, c, log_pots, masks, mask_slot, mask_vars):
    """[1 or B, *clique_shape]: the log potential plus the clique's masks
    (clamped at ``_NEG``, so a forbidden state never sums to NaN).  With at
    least one mask the result is a new tensor; without, it is a view of the
    potential."""
    cv = plan.clique_vars[c]
    bel = log_pots[c].unsqueeze(0)
    for i, v in enumerate(mask_vars):
        m = masks[mask_slot[v]].to(bel.dtype).clamp_min(_NEG)
        shape = [m.shape[0]] + [1] * len(cv)
        shape[1 + cv.index(v)] = plan.sizes[v]
        bel = _add(bel, m.reshape(shape), owned=i > 0)
    return bel


def _child_into_clique(plan, c, sep, m, trailing: int = 0):
    """A child's message ``m`` [b, *sep_shape, *trailing axes] reshaped to
    broadcast into clique ``c``'s shape (separator axes in the clique's
    order)."""
    cv = plan.clique_vars[c]
    order = sorted(range(len(sep)), key=lambda i: cv.index(sep[i]))
    nsep = len(sep)
    src = m.permute(
        [0] + [1 + i for i in order] + [1 + nsep + t for t in range(trailing)]
    )
    expand = [m.shape[0]] + [1] * len(cv) + list(m.shape[1 + nsep:])
    for i in order:
        expand[1 + cv.index(sep[i])] = plan.sizes[sep[i]]
    return src.reshape(expand)


def tree_map_program(plan: Plan, observed: Sequence[int]):
    """Build ``fn(log_pots, masks) -> (assign [B, num_vars] int32, score [B])``.

    log_pots: unbatched log-space clique potentials (max_product space).
    masks: list aligned with ``observed`` (var ids), each [B, size_v] in
    log space (0 = allowed, -inf or very negative = forbidden).
    score is the log of the unnormalized joint at the decoded assignment,
    mask contributions included: a row with no feasible assignment scores
    below -1e29 (about -1e30 for violated evidence, -inf where a potential
    is zero), never NaN.

    A clique's [B, clique_states] scores and their (sep, rest)-ordered copy
    are alive together, and one int32 [B, sep_states] backpointer per clique
    stays until the traceback; subtrees without evidence stay unbatched."""
    tree = plan.tree
    cvars = plan.clique_vars
    svars = plan.sep_vars
    observed = list(observed)
    mask_slot = {v: i for i, v in enumerate(observed)}
    cmv = clique_mask_vars(plan, observed)
    layout = _layout(plan)
    root_dec = _Decoder(cvars[tree.root], plan.sizes)

    def fn(log_pots: Sequence[torch.Tensor], masks: Sequence[torch.Tensor]):
        B = int(masks[0].shape[0]) if masks else 1
        device = log_pots[0].device

        # ---- collect: max-product messages + backpointers ----
        msgs: Dict[int, torch.Tensor] = {}
        bps: Dict[int, torch.Tensor] = {}
        root_bel = None
        for c in reversed(tree.topo_order):
            with TIMERS.span("map.collect", clique=c):
                bel = _masked_potential(plan, c, log_pots, masks, mask_slot,
                                        cmv[c])
                owned = bool(cmv[c])
                for child, s in tree.children[c]:
                    bel = _add(
                        bel,
                        _child_into_clique(plan, c, svars[s], msgs.pop(child)),
                        owned,
                    )
                    owned = True
                if c == tree.root:
                    root_bel = bel
                    continue
                perm, sep_shape, sepN, restN, _, _ = layout[c]
                b = bel.shape[0]
                p2 = bel.permute([0] + [1 + a for a in perm]).reshape(
                    b, sepN, restN)
                if p2.data_ptr() != bel.data_ptr():
                    TIMERS.add("map.materialized_bytes",
                               p2.numel() * p2.element_size())
                del bel
                vals, idx = p2.max(dim=-1)
                del p2
                msgs[c] = vals.reshape((b,) + sep_shape)
                bps[c] = idx.to(torch.int32)  # [b, sepN]

        with TIMERS.span("map.decode"):
            # ---- root decode ----
            flat = root_bel.reshape(root_bel.shape[0], -1)
            score, ridx = flat.max(dim=-1)
            if score.shape[0] != B:
                score, ridx = score.expand(B), ridx.expand(B)
            assign = torch.zeros((B, plan.num_vars), dtype=torch.int32,
                                 device=device)
            root_dec.write(assign, ridx)

            # ---- traceback (pre-order) ----
            for c in tree.topo_order[1:]:
                _, _, sepN, _, sep_dec, rest_dec = layout[c]
                sep_flat = sep_dec.flat(assign)
                rest_flat = bps.pop(c).expand(B, sepN).gather(
                    1, sep_flat[:, None])
                rest_dec.write(assign, rest_flat[:, 0].to(torch.int64))
            return assign, score

    return fn


def tree_kbest_program(plan: Plan, observed: Sequence[int], k: int):
    """Exact k-best decoding on ARBITRARY junction trees.

    k-best-semiring message passing: every upward message carries, per
    separator configuration, the ranked top-k completions of its subtree
    ([B, *sep_shape, K] score tensors).  Children are merged pairwise --
    cross the current list with the child's list, ``torch.topk`` back down
    to k -- which is exact by the standard list-Viterbi argument: for a
    fixed separator configuration the j-th best completion uses at most
    the j-th entry of each child's list, so pruning to k per merge never
    discards a top-k candidate.  Backpointers are recorded per merge stage
    and per separator projection; traceback unwinds them pre-order,
    vectorized over batch x hypothesis.

    List sizes are exact minima (min(k, candidates)), so no padding
    sentinels are needed; ranked entries are distinct assignments by
    construction (distinct (rest, rank-combination) tuples, recursively).

    Returns ``fn(log_pots, masks) -> (assign [B, K, num_vars] int32,
    scores [B, K] descending)`` with K = min(k, total assignments); masks
    as in ``tree_map_program`` (log space, aligned with ``observed``)."""
    tree = plan.tree
    cvars = plan.clique_vars
    svars = plan.sep_vars
    observed = list(observed)
    mask_slot = {v: i for i, v in enumerate(observed)}
    k = int(k)
    if k < 1:
        raise ValueError("k must be >= 1")
    cmv = clique_mask_vars(plan, observed)
    layout = _layout(plan)
    clique_dec = [_Decoder(cv, plan.sizes) for cv in cvars]

    def fn(log_pots: Sequence[torch.Tensor], masks: Sequence[torch.Tensor]):
        B = int(masks[0].shape[0]) if masks else 1
        device = log_pots[0].device

        # ---- collect: k-best lists + backpointers ----
        msgs: Dict[int, Tuple[torch.Tensor, int]] = {}  # child -> (msg, Kch)
        stage_bps: Dict[int, list] = {}  # clique -> [(child, Kch, bp|None)]
        proj_bps: Dict[int, Tuple[torch.Tensor, int]] = {}  # c -> (bp, Kc)
        root_top = None
        for c in reversed(tree.topo_order):
            shape = tuple(plan.sizes[v] for v in cvars[c])
            cliqueN = int(np.prod(shape)) if shape else 1
            bel = _masked_potential(plan, c, log_pots, masks, mask_slot, cmv[c])
            cur = bel.expand((B,) + shape).reshape(B, cliqueN, 1)
            Kc = 1
            stages = []
            for child, s in tree.children[c]:
                m, Kch = msgs.pop(child)  # [B, *sep_shape_child, Kch]
                mexp = _child_into_clique(
                    plan, c, svars[s], m, trailing=1
                ).expand((B,) + shape + (Kch,)).reshape(B, cliqueN, Kch)
                cand = (cur[:, :, :, None] + mexp[:, :, None, :]).reshape(
                    B, cliqueN, Kc * Kch
                )
                if Kc * Kch > k:
                    cand, idx = torch.topk(cand, k, dim=-1)
                    stages.append((child, Kch, idx.to(torch.int32)))
                    Kc = k
                else:
                    # full cross product kept: rank r decodes as
                    # (r // Kch, r % Kch) with no stored pointer
                    stages.append((child, Kch, None))
                    Kc = Kc * Kch
                cur = cand
            stage_bps[c] = stages
            if c == tree.root:
                Kroot = min(k, cliqueN * Kc)
                scores, top_idx = torch.topk(
                    cur.reshape(B, cliqueN * Kc), Kroot, dim=-1
                )
                root_top = (scores, top_idx, Kc, Kroot)
                continue
            perm, sep_shape, sepN, restN, _, _ = layout[c]
            p = cur.reshape((B,) + shape + (Kc,)).permute(
                [0] + [1 + a for a in perm] + [1 + len(shape)]
            ).reshape(B, sepN, restN * Kc)
            Km = min(k, restN * Kc)
            vals, idx = torch.topk(p, Km, dim=-1)
            msgs[c] = (vals.reshape((B,) + sep_shape + (Km,)), Km)
            proj_bps[c] = (idx.to(torch.int32), Kc)

        scores, top_idx, Kc_root, Kroot = root_top

        # ---- traceback, vectorized over [B, Kroot] hypotheses ----
        assign = torch.zeros(
            (B, Kroot, plan.num_vars), dtype=torch.int32, device=device
        )
        # per-clique rank within its message list, filled pre-order
        ranks: Dict[int, torch.Tensor] = {}

        def unwind(c, config_flat, rank):
            """Decode merge stages of clique c in reverse: distribute the
            hypothesis rank back into per-child ranks."""
            for child, Kch, bp in reversed(stage_bps[c]):
                if bp is not None:
                    # bp: [B, cliqueN, k]; gather at (config, rank)
                    kdim = bp.shape[-1]
                    r = bp.reshape(B, -1).gather(
                        1, config_flat * kdim + rank
                    ).to(torch.int64)
                else:
                    r = rank
                ranks[child] = r % Kch
                rank = r // Kch

        # root: flat index = config * Kc_root + rank
        config = top_idx // Kc_root                        # [B, Kroot]
        clique_dec[tree.root].write(assign, config)
        unwind(tree.root, config, top_idx % Kc_root)

        for c in tree.topo_order[1:]:
            _, _, _, _, sep_dec, rest_dec = layout[c]
            bp, Kc = proj_bps[c]                           # [B, sepN, Km]
            Km = bp.shape[-1]
            val = bp.reshape(B, -1).gather(
                1, sep_dec.flat(assign) * Km + ranks[c]
            ).to(torch.int64)                              # [B, Kroot]
            rest_dec.write(assign, val // Kc)
            # clique config in cvars[c] axis order for the stage gathers
            unwind(c, clique_dec[c].flat(assign), val % Kc)

        return assign, scores

    return fn
