"""Chain executor: forward-backward serving for chain-structured trees
(counterpart of ``junctiontree_tpu/scan_executor.py``).

A chain junction tree with uniform cardinality K is exactly a batched HMM:
collect = forward pass of masked matrix products, distribute = backward
pass, with per-step rescaling so everything stays in linear space
(``[B, K] x [K, K]`` products).

  F_0 = 1;  F_{k+1}[b,q] = sum_p F_k[b,p] * M_k[b,p] * pot_k[p,q]
  G_m = 1;  G_k[b,p]     = sum_q pot_k[p,q] * M_{k+1}[b,q] * G_{k+1}[b,q]
  posterior(v_k) ∝ F_k ⊙ M_k ⊙ G_k;   logZ = log Σ_p F_m M_m + offsets

PyTorch runs eagerly, so the two passes are Python loops over preallocated
``[m+1, B, K]`` stacks, a handful of small device operations per step.

The same layout serves exact MAP (``chain_viterbi_program``) and k-best
decoding (``chain_kbest_program``) in log space: a forward loop of maxima
with backpointers written into a preallocated stack, then a traceback loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .ops.semirings import pinned_precision
from .schedule import Plan

_TINY = 1e-38


@dataclass(frozen=True)
class ChainLayout:
    """A junction tree recognized as a uniform chain.

    var_order: v_0..v_m (chain order, interned ids)
    clique_order: c_0..c_{m-1}; clique k covers (v_k, v_{k+1})
    transpose: per clique, True if its potential (axes in sorted-var order)
               must be transposed to get (v_k, v_{k+1}) layout
    card: the common cardinality K
    """

    var_order: List[int]
    clique_order: List[int]
    transpose: List[bool]
    card: int

    @staticmethod
    def detect(plan: Plan) -> Optional["ChainLayout"]:
        tree = plan.tree
        n = tree.num_cliques
        if n < 2:
            return None
        # every clique exactly 2 vars, every separator exactly 1 var
        if any(len(c) != 2 for c in plan.clique_vars):
            return None
        if any(len(s) != 1 for s in tree.separators):
            return None
        # path topology: degree <= 2, exactly two endpoints
        deg = [0] * n
        adj: List[List[int]] = [[] for _ in range(n)]
        for a, b, _ in tree.edges:
            deg[a] += 1
            deg[b] += 1
            adj[a].append(b)
            adj[b].append(a)
        ends = [i for i in range(n) if deg[i] == 1]
        if len(ends) != 2 or any(d > 2 for d in deg):
            return None
        # uniform cardinality
        cards = {plan.sizes[v] for c in plan.clique_vars for v in c}
        if len(cards) != 1:
            return None
        card = cards.pop()
        # walk the path
        order = [ends[0]]
        prev = -1
        while len(order) < n:
            cur = order[-1]
            nxt = [x for x in adj[cur] if x != prev]
            if len(nxt) != 1:
                return None
            prev = cur
            order.append(nxt[0])
        # recover the var chain: v_0 is the var of c_0 not shared with c_1
        var_order: List[int] = []
        transpose: List[bool] = []
        first = set(plan.clique_vars[order[0]])
        shared01 = first & set(plan.clique_vars[order[1]])
        if len(shared01) != 1:
            return None
        v0 = (first - shared01).pop()
        var_order.append(v0)
        cur_var = v0
        for c in order:
            cv = plan.clique_vars[c]
            if cur_var not in cv:
                return None
            nxt_var = cv[1] if cv[0] == cur_var else cv[0]
            transpose.append(cv[0] != cur_var)
            var_order.append(nxt_var)
            cur_var = nxt_var
        # chain must cover every variable exactly once
        if sorted(var_order) != list(range(plan.num_vars)):
            return None
        return ChainLayout(var_order, order, transpose, card)


def stack_chain_potentials(
    layout: ChainLayout, pots_np: Sequence[np.ndarray]
) -> np.ndarray:
    """Host-side prestack of clique potentials into the [m, K, K] transition
    tensor (done once per ``set_potentials``)."""
    return np.stack(
        [
            np.transpose(pots_np[c]) if layout.transpose[k] else pots_np[c]
            for k, c in enumerate(layout.clique_order)
        ]
    )


def _rescaled_step(x, mat, out=None, s_out=None):
    """One rescaled chain step: ``x @ mat`` divided by its floored row
    maximum; returns (result, maxima [B, 1]).  With ``out`` / ``s_out`` (rows
    of preallocated stacks) both are written in place; without them the step
    is functional, as autograd needs it."""
    y = torch.matmul(x, mat)
    if out is None:
        s = y.amax(dim=-1, keepdim=True).clamp_min(_TINY)
        return y / s, s
    if s_out is None:
        s = y.amax(dim=-1, keepdim=True).clamp_(min=_TINY)
    else:
        s = torch.amax(y, dim=-1, keepdim=True, out=s_out).clamp_(min=_TINY)
    return torch.div(y, s, out=out), s


def _chain_forward(layout: ChainLayout, A: torch.Tensor, masks):
    """Forward pass of the chain program: ``(M, F_all, logZ, functional)``
    with the stacked masks ``M`` and forward messages ``F_all``, both
    [m+1, B, K].  When ``A`` requires a gradient (and gradients are on) every
    step is functional and the stacks are ``torch.stack`` of the steps; else
    the steps write into preallocated stacks in place."""
    m, K = len(layout.clique_order), layout.card
    dtype, device = A.dtype, A.device
    if isinstance(masks, dict):
        chain_pos = {v: k for k, v in enumerate(layout.var_order)}
        B = next(iter(masks.values())).shape[0] if masks else 1
        # ones everywhere, the (few) observed variables written by index
        M = torch.ones((m + 1, B, K), dtype=dtype, device=device)
        if masks:
            at = torch.tensor(
                [chain_pos[v] for v in masks], dtype=torch.long, device=device
            )
            M[at] = torch.stack(
                [mk.to(dtype=dtype, device=device) for mk in masks.values()]
            )
    else:
        M = masks.to(dtype=dtype, device=device)
        B = M.shape[1]
    functional = A.requires_grad and torch.is_grad_enabled()
    F_all = scale = None
    F_rows = s_rows = [None] * (m + 1)
    if not functional:
        F_all = torch.empty((m + 1, B, K), dtype=dtype, device=device)
        scale = torch.empty((m, B, 1), dtype=dtype, device=device)
        F_all[0] = 1.0
        F_rows, s_rows = F_all.unbind(0), scale.unbind(0)
    # one unbind each, not one index per step (and per backward step)
    Ms, As = M.unbind(0), A.unbind(0)
    # each step's max lands in `scale`, whose logs sum to the logZ offset
    Fs = [torch.ones((B, K), dtype=dtype, device=device) if functional
          else F_rows[0]]
    ss = []
    for k in range(m):
        f, s = _rescaled_step(Fs[-1] * Ms[k], As[k], F_rows[k + 1], s_rows[k])
        Fs.append(f)
        ss.append(s)
    if functional:
        F_all, scale = torch.stack(Fs), torch.stack(ss)
    zfin = (F_all[m] * M[m]).sum(dim=-1)
    logz = torch.where(
        zfin > 0, torch.log(zfin.clamp_min(_TINY)),
        torch.full_like(zfin, -float("inf")),
    ) + torch.log(scale).sum(dim=0)[:, 0]
    return M, F_all, logz, functional


def chain_logz_program(plan: Plan, layout: ChainLayout):
    """Build ``fn(A, masks) -> logZ [B]``: the forward half of
    :func:`chain_posterior_program` (same arguments).  What a learner
    differentiates: logZ needs no backward messages and no posteriors."""

    def fn(A: torch.Tensor, masks):
        with pinned_precision():
            return _chain_forward(layout, A, masks)[2]

    return fn


def chain_posterior_program(plan: Plan, layout: ChainLayout):
    """Build ``fn(A, masks) -> (stacked posteriors [m+1, B, K], logZ [B])``.

    ``A``: prestacked [m, K, K] transitions (``stack_chain_potentials``),
    linear space, on the device the program runs on.  ``masks``: dict var_id
    -> [B, K] linear-space mask (observed vars only), or a prestacked
    [m+1, B, K] mask tensor in chain order (dense evidence).  The posteriors
    come back stacked in chain order; :class:`StackedPosteriors` maps var
    ids to positions.  The program is differentiable in ``A``: it updates
    its stacks in place unless ``A`` requires a gradient."""
    m = len(layout.clique_order)

    def fn(A: torch.Tensor, masks):
        with pinned_precision():
            return _posteriors(A, masks)

    def _posteriors(A, masks):
        M, F_all, logz, functional = _chain_forward(layout, A, masks)
        Ats, Ms = A.transpose(1, 2).unbind(0), M.unbind(0)
        G_all = None if functional else torch.empty_like(F_all)
        G_rows = [None] * (m + 1) if functional else G_all.unbind(0)
        Gs = [torch.ones_like(F_all[m])] * (m + 1)
        if not functional:
            G_all[m] = 1.0
            Gs[m] = G_rows[m]
        for k in range(m - 1, -1, -1):
            Gs[k], _ = _rescaled_step(Ms[k + 1] * Gs[k + 1], Ats[k], G_rows[k])
        # posteriors per chain position, normalized (scales cancel)
        if functional:
            post = F_all * M * torch.stack(Gs)
            return post / post.sum(dim=-1, keepdim=True).clamp_min(_TINY), logz
        post = F_all.mul_(M).mul_(G_all)
        return post.div_(post.sum(dim=-1, keepdim=True).clamp_min(_TINY)), logz

    return fn


def _stack_log_masks(layout: ChainLayout, logmasks, dtype, device):
    """(LM [m+1, B, K] with zeros for unobserved positions, B)."""
    m, K = len(layout.clique_order), layout.card
    chain_pos = {v: k for k, v in enumerate(layout.var_order)}
    B = next(iter(logmasks.values())).shape[0] if logmasks else 1
    LM = torch.zeros((m + 1, B, K), dtype=dtype, device=device)
    if logmasks:
        at = torch.tensor(
            [chain_pos[v] for v in logmasks], dtype=torch.long, device=device
        )
        LM[at] = torch.stack(
            [torch.as_tensor(mk).to(dtype=dtype, device=device)
             for mk in logmasks.values()]
        )
    return LM, B


def _to_var_columns(layout: ChainLayout, chain_assign: torch.Tensor):
    """[m+1, ...] states in chain order -> [..., m+1] int32 in var-id column
    order."""
    order = torch.as_tensor(
        np.argsort(np.asarray(layout.var_order)), device=chain_assign.device
    )
    return chain_assign.movedim(0, -1)[..., order].to(torch.int32)


def chain_viterbi_program(plan: Plan, layout: ChainLayout):
    """Exact MAP decoding on a uniform chain: log-space max forward loop
    with argmax bookkeeping, then a traceback loop (classic Viterbi), three
    device operations per forward step and one per traceback step.

    Returns ``fn(logA, logmasks) -> (assignment [B, m+1] int32, score [B])``
    where ``logA`` is the [m, K, K] log-transition stack (log of
    ``stack_chain_potentials``) and ``logmasks`` a dict var_id -> [B, K]
    log-space mask (0 / -inf).  A row with no feasible path scores -inf."""
    m = len(layout.clique_order)
    K = layout.card

    def fn(logA: torch.Tensor, logmasks: Dict[int, torch.Tensor]):
        dtype, device = logA.dtype, logA.device
        LM, B = _stack_log_masks(layout, logmasks, dtype, device)
        ptrs = torch.empty((m, B, K), dtype=torch.int64, device=device)
        V = torch.zeros((B, K), dtype=dtype, device=device)
        Vbuf = torch.empty((2, B, K), dtype=dtype, device=device)
        for k in range(m):
            # scores[b, p, q] = V[b,p] + lm[b,p] + a[p,q]
            scores = (V + LM[k]).unsqueeze(2) + logA[k]
            V = Vbuf[k % 2]
            torch.max(scores, dim=1, out=(V, ptrs[k]))
        score, x_last = (V + LM[m]).max(dim=-1)
        chain = torch.empty((m + 1, B), dtype=torch.int64, device=device)
        chain[m] = x_last
        for k in range(m - 1, -1, -1):
            torch.gather(
                ptrs[k], 1, chain[k + 1].unsqueeze(1), out=chain[k].unsqueeze(1)
            )
        return _to_var_columns(layout, chain), score

    return fn


_KBEST_PAD = -2e30
_KBEST_PAD_FLOOR = -1e29  # scores below this are padding, not real paths


def chain_kbest_program(plan: Plan, layout: ChainLayout, k: int):
    """Exact k-best decoding on a uniform chain (list-Viterbi): the forward
    loop carries the top-k path scores per state ([B, K, k]); each step
    ranks the K*k candidate extensions per successor state with
    ``torch.topk``; traceback follows (state, rank) pointers.

    Distinct ranks are distinct PATHS by construction (each candidate is a
    distinct (predecessor state, predecessor rank) pair).  When fewer than
    k paths exist (k > K at early steps), padding entries score about -2e30:
    callers drop scores below ``_KBEST_PAD_FLOOR``.

    Returns ``fn(logA, logmasks) -> (assign [B, k, m+1] int32 in var-id
    column order, scores [B, k] descending)``."""
    m = len(layout.clique_order)
    K = layout.card
    k = int(k)

    def fn(logA: torch.Tensor, logmasks: Dict[int, torch.Tensor]):
        dtype, device = logA.dtype, logA.device
        LM, B = _stack_log_masks(layout, logmasks, dtype, device)
        V = torch.full((B, K, k), _KBEST_PAD, dtype=dtype, device=device)
        V[:, :, 0] = 0.0
        Vbuf = torch.empty((2, B, K, k), dtype=dtype, device=device)
        ptrs = torch.empty((m, B, K, k), dtype=torch.int64, device=device)
        for t in range(m):
            # cand[b, q, (p, r)] = V[b,p,r] + lm[b,p] + a[p,q]
            cand = (
                (V + LM[t].unsqueeze(2)).unsqueeze(1)
                + logA[t].t()[None, :, :, None]
            ).reshape(B, K, K * k)
            V = Vbuf[t % 2]
            torch.topk(cand, k, dim=-1, out=(V, ptrs[t]))
        final = (V + LM[m].unsqueeze(2)).reshape(B, K * k)
        scores, flat = torch.topk(final, k, dim=-1)       # [B, k]
        chain = torch.empty((m + 1, B, k), dtype=torch.int64, device=device)
        chain[m] = flat // k                              # state q
        r = flat % k                                      # rank within q
        for t in range(m - 1, -1, -1):
            # flat predecessor pointer for every kept path
            f = ptrs[t].reshape(B, K * k).gather(1, chain[t + 1] * k + r)
            chain[t] = f // k
            r = f % k
        return _to_var_columns(layout, chain), scores

    return fn


class StackedPosteriors:
    """Lazy per-variable-id view over the chain program's stacked
    [m+1, B, K] posterior tensor.  Behaves like the list of tensors the
    general program returns (``post[var_id]`` -> [B, K])."""

    def __init__(self, stacked: torch.Tensor, var_order: Sequence[int]):
        self._stacked = stacked
        self._pos: Dict[int, int] = {v: k for k, v in enumerate(var_order)}

    @property
    def stacked(self) -> torch.Tensor:
        return self._stacked

    def __len__(self) -> int:
        return len(self._pos)

    def __getitem__(self, var_id: int) -> torch.Tensor:
        return self._stacked[self._pos[var_id]]

    def __iter__(self):
        for v in range(len(self._pos)):
            yield self[v]
