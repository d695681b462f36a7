"""Chain executor: forward-backward serving for chain-structured trees
(counterpart of ``junctiontree_tpu/scan_executor.py``).

A chain junction tree with uniform cardinality K is exactly a batched HMM:
collect = forward pass of masked matrix products, distribute = backward
pass, with per-step rescaling so everything stays in linear space
(``[B, K] x [K, K]`` products).

  F_0 = 1;  F_{k+1}[b,q] = sum_p F_k[b,p] * M_k[b,p] * pot_k[p,q]
  G_m = 1;  G_k[b,p]     = sum_q pot_k[p,q] * M_{k+1}[b,q] * G_{k+1}[b,q]
  posterior(v_k) ∝ F_k ⊙ M_k ⊙ G_k;   logZ = log Σ_p F_m M_m + offsets

PyTorch runs eagerly, so the two passes are Python loops over a
preallocated ``[m+1, B, K]`` forward stack.  A step is the product, then
one row pass for the row maximum, the divide and the next product's mask
multiply (``ops.chain_step``: in float32 on the card one row kernel, so
two launches; its plain PyTorch version elsewhere), and the backward pass
writes each position's posterior as it goes, keeping the backward
messages in two [B, K] buffers in turn.  Under a gradient through the
transitions the steps are functional instead, as autograd needs them.

The same layout serves exact MAP (``chain_viterbi_program``) and k-best
decoding (``chain_kbest_program``) in log space: a forward loop of maxima
with backpointers written into a preallocated stack, then a traceback loop.

A hidden Markov model is a uniform chain with leaves: each leaf variable
sits in a 2-variable clique with one hidden variable (:class:`HMMLayout`).
``hmm_posterior_program`` folds the leaves' evidence into the hidden masks
(one batched product), runs the chain's two passes, and takes every leaf's
posterior from its hidden variable's (one batched product).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import chain_step
from .ops.semirings import pinned_precision
from .schedule import Plan
from .utils.timing import TIMERS

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
        """Every clique over two variables, every separator over one, one
        cardinality, and the cliques a path over every variable, walked
        from the end whose clique comes first."""
        cvs = plan.clique_vars
        cards = {plan.sizes[v] for c in cvs for v in c}
        if not _pairwise(plan) or len(cards) != 1:
            return None
        walk = _walk_path(cvs, range(len(cvs)), by_clique=True)
        if walk is None or sorted(walk[0]) != list(range(plan.num_vars)):
            return None
        return ChainLayout(*walk, cards.pop())


def _pairwise(plan: Plan) -> bool:
    """At least two cliques, each over two variables, and every separator
    over one."""
    return (plan.tree.num_cliques >= 2
            and all(len(c) == 2 for c in plan.clique_vars)
            and all(len(s) == 1 for s in plan.tree.separators))


def _walk_path(cvs, cliques, by_clique: bool):
    """``(var_order, clique_order, transpose)`` of the path that the
    two-variable cliques ``cliques`` (indices into ``cvs``) form over their
    variables, walked from one of its two end variables: the one whose
    clique comes first (``by_clique``) or the one with the smaller id.
    ``transpose[k]`` is True where clique k's variables are (v_{k+1}, v_k).
    None unless the cliques form one path."""
    adj: Dict[int, List[int]] = {}
    for c in cliques:
        for v in cvs[c]:
            adj.setdefault(v, []).append(c)
    ends = [v for v, cs in adj.items() if len(cs) == 1]
    if len(ends) != 2 or any(len(cs) > 2 for cs in adj.values()):
        return None
    var_order, clique_order, transpose = [min(
        ends, key=lambda v: (adj[v][0], v) if by_clique else v)], [], []
    prev = -1
    while len(clique_order) < len(cliques):
        nxt = [c for c in adj[var_order[-1]] if c != prev]
        if len(nxt) != 1:
            return None
        c = prev = nxt[0]
        a, b = cvs[c]
        transpose.append(a != var_order[-1])
        var_order.append(b if a == var_order[-1] else a)
        clique_order.append(c)
    if len(set(var_order)) != len(var_order):
        return None
    return var_order, clique_order, transpose


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


def _rescaled_step(x, mat):
    """One rescaled chain step, functional as autograd needs it: ``x @
    mat`` divided by its floored row maximum, and those maxima [B, 1]."""
    y = torch.matmul(x, mat)
    s = y.amax(dim=-1, keepdim=True).clamp_min(_TINY)
    return y / s, s


def _stack_masks(layout: ChainLayout, masks, dtype, device) -> torch.Tensor:
    """The [m+1, B, K] chain-order mask stack of a dict var_id -> [B, K]
    mask (unobserved positions all ones), or a prestacked one as given."""
    if not isinstance(masks, dict):
        return masks.to(dtype=dtype, device=device)
    m, K = len(layout.clique_order), layout.card
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
    return M


def _chain_forward(layout: ChainLayout, A: torch.Tensor, masks):
    """Forward pass of the chain program: ``(M, F_all, logZ, functional)``
    with the stacked masks ``M`` and forward messages ``F_all``, both
    [m+1, B, K].  When ``A`` requires a gradient (and gradients are on) every
    step is functional (:func:`_rescaled_step`) and ``F_all`` is the
    ``torch.stack`` of F_k; else ``chain_step.forward_step`` writes into
    preallocated stacks in place, and ``F_all[k]`` holds F_k ⊙ M_k for k <
    m: the next product's operand, and what the backward pass's posterior
    reads."""
    m = len(layout.clique_order)
    dtype, device = A.dtype, A.device
    # the row kernel reads whole contiguous rows
    M = _stack_masks(layout, masks, dtype, device).contiguous()
    B, K = M.shape[1], M.shape[2]
    functional = A.requires_grad and torch.is_grad_enabled()
    # one unbind each, not one index per step (and per backward step)
    Ms, As = M.unbind(0), A.unbind(0)
    TIMERS.add("chain.products", m)
    with TIMERS.span("chain.forward", M=m + 1, B=B, K=K,
                     products=[[m, B, K, K]]):
        if functional:
            Fs, ss = [torch.ones((B, K), dtype=dtype, device=device)], []
            for k in range(m):
                f, s = _rescaled_step(Fs[-1] * Ms[k], As[k])
                Fs.append(f)
                ss.append(s)
            F_all, scale = torch.stack(Fs), torch.stack(ss)
        else:
            F_all = torch.empty((m + 1, B, K), dtype=dtype, device=device)
            # each step's max lands in `scale`, whose logs sum to the logZ
            # offset
            scale = torch.empty((m, B, 1), dtype=dtype, device=device)
            F_all[0].copy_(M[0])  # F_0 ⊙ M_0
            F_rows, s_rows = F_all.unbind(0), scale.unbind(0)
            for k in range(m):
                chain_step.forward_step(F_rows[k], As[k], Ms[k + 1]
                                        if k + 1 < m else None,
                                        F_rows[k + 1], s_rows[k])
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

    def fn(A: torch.Tensor, masks):
        with pinned_precision():
            return _chain_posteriors(layout, A, masks)

    return fn


def _chain_posteriors(layout: ChainLayout, A: torch.Tensor, masks):
    """Forward pass, backward pass and the normalized posteriors of the
    chain program: (stacked posteriors [m+1, B, K], logZ [B]).  Unless the
    steps are functional the posteriors are written over the forward
    stack."""
    m = len(layout.clique_order)
    M, F_all, logz, functional = _chain_forward(layout, A, masks)
    B, K = F_all.shape[1], F_all.shape[2]
    Ms = M.unbind(0)
    TIMERS.add("chain.products", m)
    with TIMERS.span("chain.backward", M=m + 1, B=B, K=K,
                     products=[[m, B, K, K]]):
        if functional:
            Ats = A.transpose(1, 2).unbind(0)
            Gs = [torch.ones_like(F_all[m])] * (m + 1)
            for k in range(m - 1, -1, -1):
                Gs[k], _ = _rescaled_step(Ms[k + 1] * Gs[k + 1], Ats[k])
            # posteriors per chain position, normalized (scales cancel)
            post = F_all * M * torch.stack(Gs)
            return post / post.sum(dim=-1, keepdim=True).clamp_min(_TINY), logz
        # M_k ⊙ G_k lives until step k - 1 has read it: two [B, K] buffers
        # in turn; each step writes position k's posterior over F_k ⊙ M_k,
        # which the forward pass left in F_k's place
        G = torch.empty((2, B, K), dtype=F_all.dtype, device=F_all.device)
        F_rows, As = F_all.unbind(0), A.unbind(0)
        for k in range(m - 1, -1, -1):  # M_m ⊙ G_m = M_m
            chain_step.backward_step(G[(k + 1) % 2] if k < m - 1 else Ms[m],
                                     As[k], Ms[k] if k else None, G[k % 2],
                                     F_rows[k])
        last = F_all[m].mul_(M[m])
        last.div_(last.sum(dim=-1, keepdim=True).clamp_min(_TINY))
        return F_all, logz


@dataclass(frozen=True)
class HMMLayout:
    """A junction tree recognized as a hidden Markov model: a uniform chain
    of hidden variables, each carrying zero or more leaf variables.

    chain: the hidden chain as a :class:`ChainLayout` (its cliques only)
    leaf_vars, leaf_pos, leaf_clique, leaf_transpose: per leaf, its
        variable id, the chain position of its hidden variable, its
        clique, and True where the clique's potential must be transposed
        to (hidden, leaf) layout.  Leaves come grouped by cardinality
        (ascending); within a group, by their rank among the group's
        leaves of the same hidden variable, then by position.
    groups: per cardinality C, (C, first, end) of its slice of the leaves.
    """

    chain: ChainLayout
    leaf_vars: List[int]
    leaf_pos: List[int]
    leaf_clique: List[int]
    leaf_transpose: List[bool]
    groups: List[Tuple[int, int, int]]

    @staticmethod
    def detect(plan: Plan) -> Optional["HMMLayout"]:
        """Hidden variables are those in more than one clique, leaves those
        in one clique only, beside one hidden variable.  The cliques over
        two hidden variables must form a path of at least one clique over
        all of them, of one cardinality; a chain end that carries no leaf
        is then a leaf of its neighbour.  Where a leaf clique hangs in the
        tree does not matter: the model is the product of the clique
        potentials."""
        cvs = plan.clique_vars
        if not _pairwise(plan):
            return None
        occ = Counter(v for c in cvs for v in c)
        hidden = {v for v, n in occ.items() if n > 1}
        chain_cliques = [c for c, vs in enumerate(cvs)
                         if vs[0] in hidden and vs[1] in hidden]
        if (not chain_cliques or len(chain_cliques) != len(hidden) - 1
                or len({plan.sizes[v] for v in hidden}) != 1):
            return None
        walk = _walk_path(cvs, chain_cliques, by_clique=False)
        if walk is None:
            return None
        var_order = walk[0]
        chain = ChainLayout(*walk, plan.sizes[var_order[0]])
        pos = {v: k for k, v in enumerate(var_order)}
        leaves = []       # (card, rank, position, leaf, clique, transpose)
        rank: Dict[Tuple[int, int], int] = {}
        for c, (a, b) in enumerate(cvs):
            if a in hidden and b in hidden:
                continue
            h, leaf = (a, b) if a in hidden else (b, a)
            card = plan.sizes[leaf]
            r = rank[(card, h)] = rank.get((card, h), -1) + 1
            leaves.append((card, r, pos[h], leaf, c, a != h))
        leaves.sort()
        groups = []
        for i, lf in enumerate(leaves):
            if not groups or groups[-1][0] != lf[0]:
                groups.append([lf[0], i, i])
            groups[-1][2] = i + 1
        cols = list(zip(*leaves)) if leaves else [()] * 6
        return HMMLayout(chain, list(cols[3]), list(cols[2]), list(cols[4]),
                         list(cols[5]), [tuple(g) for g in groups])


@dataclass
class HMMStacks:
    """What the HMM program reads of the potentials, stacked on the device
    once per ``set_potentials`` (:func:`stack_hmm_potentials`).

    A: the hidden chain's [m, K, K] transitions.  R: each leaf's row sums
    [L, K] (its likelihood when unobserved).  Per leaf group: E, the
    leaves' [Lg, K, C] potentials in (hidden, leaf) layout, and Ebar, E
    with each row divided by its sum (zero rows stay zero).  pos: the
    leaves' chain positions [L] (int64)."""

    A: torch.Tensor
    R: torch.Tensor
    E: List[torch.Tensor]
    Ebar: List[torch.Tensor]
    pos: torch.Tensor


def stack_hmm_potentials(layout: HMMLayout, pots: Sequence[torch.Tensor]):
    """:class:`HMMStacks` of the clique potentials as the plan evaluated
    them (a leaf clique that holds a hidden variable's unary or the prior
    keeps it), on their device."""
    ch = layout.chain
    A = torch.stack([pots[c].t() if t else pots[c]
                     for c, t in zip(ch.clique_order, ch.transpose)])
    E_all = [pots[c].t() if t else pots[c]
             for c, t in zip(layout.leaf_clique, layout.leaf_transpose)]
    R = torch.stack([e.sum(dim=1) for e in E_all]) if E_all else A.new_empty(
        (0, ch.card))
    E, Ebar = [], []
    for _, lo, hi in layout.groups:
        e = torch.stack(E_all[lo:hi])
        r = R[lo:hi, :, None]
        E.append(e)
        Ebar.append(torch.where(r > 0, e / torch.where(r > 0, r, 1.0), 0.0))
    pos = torch.as_tensor(layout.leaf_pos, dtype=torch.int64,
                          device=A.device)
    return HMMStacks(A, R, E, Ebar, pos)


def _scale_rows(target: torch.Tensor, at: Sequence[int], factors) -> None:
    """``target[at[i]] *= factors[i]`` for every i, rows named more than
    once included: one gather, product and scatter per round of distinct
    rows."""
    rank, seen = [], {}
    for p in at:
        rank.append(seen.get(p, 0))
        seen[p] = rank[-1] + 1
    for r in range(max(rank, default=-1) + 1):
        sel = [i for i, k in enumerate(rank) if k == r]
        rows = torch.as_tensor([at[i] for i in sel], device=target.device)
        f = factors if len(sel) == len(at) else factors[
            torch.as_tensor(sel, device=target.device)]
        target.index_copy_(0, rows, target.index_select(0, rows).mul_(f))


def hmm_posterior_program(plan: Plan, layout: HMMLayout):
    """Build ``fn(stacks, masks) -> (posteriors, logZ [B])`` for an HMM
    layout: ``stacks`` from :func:`stack_hmm_potentials`, ``masks`` a dict
    var_id -> [B, card] linear mask of the observed variables, hidden or
    leaf.  The posteriors map every variable id (:class:`StackedPosteriors`).

    * ``chain.leaves`` (before the passes): the hidden mask stack
      [m+1, B, K] starts as the unobserved leaves' row sums at each
      position (not assumed to be 1), is multiplied by the hidden
      variables' own masks, and by each observed leaf's likelihood
      ``mask_leaf @ E_leaf^T``, one batched product per leaf cardinality.
    * ``chain.forward`` / ``chain.backward``: the chain program's rescaled
      passes over that stack, and the hidden posteriors.
    * ``chain.leaves`` (after): a leaf's posterior is proportional to
      (F ⊙ G ⊙ the hidden variable's other masks) @ E_leaf ⊙ its own mask.
      That is the hidden posterior divided by the leaf's own likelihood:
      for unobserved leaves the division by the row sums is folded into
      ``Ebar``, so one batched product over the hidden posteriors serves
      them all (directly on the posterior stack where the group's first
      leaves sit one at each position in order); observed leaves divide
      by their likelihood (where it is 0 so is the posterior) and take a
      batched product of their own.

    Impossible evidence gives zero posteriors and logZ = -inf."""
    ch = layout.chain
    m1, K = len(ch.var_order), ch.card
    hpos = {v: k for k, v in enumerate(ch.var_order)}
    leaf_of = {v: i for i, v in enumerate(layout.leaf_vars)}
    # groups whose leaves' first m1 sit one at each position in order
    direct = [m1 if hi - lo >= m1 and layout.leaf_pos[lo:lo + m1]
              == list(range(m1)) else 0 for _, lo, hi in layout.groups]

    def fn(stacks: HMMStacks, masks: Dict[int, torch.Tensor]):
        with pinned_precision():
            return _hmm_posteriors(stacks, masks)

    def _hmm_posteriors(st, masks):
        A = st.A
        dtype, device = A.dtype, A.device
        masks = {v: mk.to(dtype=dtype, device=device)
                 for v, mk in masks.items()}
        B = next(iter(masks.values())).shape[0] if masks else 1
        observed = sorted(leaf_of[v] for v in masks if v in leaf_of)
        unobserved = sorted(set(range(len(leaf_of))) - set(observed))
        # per group: its observed leaves, their rows in the group's stacks,
        # their masks [n, B, C], and (filled below) their likelihoods
        groups = []
        for C, lo, hi in layout.groups:
            og = [i for i in observed if lo <= i < hi]
            rel = mk = None
            if og:
                rel = torch.as_tensor([i - lo for i in og], device=device)
                mk = torch.stack([masks[layout.leaf_vars[i]] for i in og])
            groups.append([C, lo, hi, og, rel, mk, None])
        TIMERS.add("chain.leaf_vars", len(leaf_of))
        cards = [g[0] for g in groups]
        with TIMERS.span("chain.leaves", M=m1, B=B, K=K, C=cards,
                         leaves=len(observed),
                         products=[[len(og), B, C, K]
                                   for C, _, _, og, _, _, _ in groups if og]):
            U = torch.ones((m1, K), dtype=dtype, device=device)
            if unobserved:
                _scale_rows(U, [layout.leaf_pos[i] for i in unobserved],
                            st.R[torch.as_tensor(unobserved, device=device)])
            M = torch.empty((m1, B, K), dtype=dtype, device=device)
            M.copy_(U[:, None, :])
            for v, mk in masks.items():
                if v in hpos:
                    M[hpos[v]].mul_(mk)
            for g, grp in enumerate(groups):
                _, _, _, og, rel, mk, _ = grp
                if og:
                    grp[6] = torch.bmm(mk, st.E[g][rel].transpose(1, 2))
                    _scale_rows(M, [layout.leaf_pos[i] for i in og], grp[6])
        post, logz = _chain_posteriors(ch, A, M)
        del M
        prods = []
        for C, lo, hi, og, _, _, _ in groups:
            prods += [[hi - lo, B, K, C]] + ([[len(og), B, K, C]] if og else [])
        outs = []
        with TIMERS.span("chain.leaves", M=m1, B=B, K=K, C=cards,
                         leaves=len(leaf_of), products=prods):
            for g, (C, lo, hi, og, rel, mk, lam) in enumerate(groups):
                out = torch.empty((hi - lo, B, C), dtype=dtype, device=device)
                d = direct[g]
                if d:
                    torch.matmul(post, st.Ebar[g][:d], out=out[:d])
                if hi - lo > d:
                    torch.matmul(post.index_select(0, st.pos[lo + d:hi]),
                                 st.Ebar[g][d:], out=out[d:])
                if og:
                    x = post.index_select(0, st.pos[lo + rel]).div_(
                        lam.clamp_min_(_TINY))
                    out.index_copy_(0, rel, torch.bmm(x, st.E[g][rel]).mul_(mk))
                outs.append(out.div_(
                    out.sum(dim=-1, keepdim=True).clamp_min(_TINY)))
        leaves = {layout.leaf_vars[i]: (outs[g], i - lo)
                  for g, (_, lo, hi) in enumerate(layout.groups)
                  for i in range(lo, hi)}
        return StackedPosteriors(post, ch.var_order, leaves), logz

    return fn


def _scan_products(X: torch.Tensor, S: torch.Tensor, reverse: bool):
    """Inclusive scan of max-normalized matrix products over axis 0 of
    ``X`` [n, B, K, K] with log offsets ``S`` [n, B] (Hillis-Steele: one
    batched product per level, ceil(log2 n) levels).  Prefixes
    ``X[k] <- X[0] ... X[k]``, or with ``reverse`` suffixes
    ``X[k] <- X[k] ... X[n-1]``: either way the earlier step stays the left
    factor.  Each product is divided by its maximum per row of the batch
    (floored at 1e-38) and the log of that maximum added to the offsets."""
    n, d = X.shape[0], 1
    while d < n:
        prod = torch.matmul(X[:-d], X[d:])   # X[k] covers d steps from k
        c = prod.amax(dim=(-2, -1)).clamp_min(_TINY)
        prod = prod / c[..., None, None]
        s = S[:-d] + S[d:] + torch.log(c)
        if reverse:
            X, S = torch.cat([prod, X[n - d:]]), torch.cat([s, S[n - d:]])
        else:
            X, S = torch.cat([X[:d], prod]), torch.cat([S[:d], s])
        d *= 2
    return X, S


def chain_posterior_parallel_program(plan: Plan, layout: ChainLayout):
    """Build ``fn(A, masks) -> (stacked posteriors [m+1, B, K], logZ [B])``:
    the chain's forward and backward recurrences as log-depth scans.

    Same contract as :func:`chain_posterior_program`, except that ``A`` may
    also be a list of consecutive step blocks of the [m, K, K] transitions,
    each on its own device (``Engine.shard_sequence``).  The forward
    messages are F_{k+1} = 1^T T_0 ... T_k with T_k = diag(M_k) A_k, the
    backward ones G_k = T'_k ... T'_{m-1} 1 with T'_k = A_k diag(M_{k+1});
    every product of the scans is max-normalized with its log offset kept,
    so long chains stay in range.  Each block scans its own steps where it
    lies; then the blocks' boundary messages are carried across in order
    (block i's forward carry is F at its first step, its backward carry G
    after its last), one [B, K] x [K, K] product per step of each block.
    This is what partitioning one scan over the devices amounts to.

    K^3 work per step against the sequential program's K^2, in about
    2 ceil(log2 m) levels of batched products instead of a loop of m steps;
    ``posterior_batch`` takes it only on an engine with ``shard_sequence``.
    Impossible evidence gives zero posteriors and logZ = -inf."""

    def fn(A, masks):
        with pinned_precision():
            return _parallel_posteriors(layout, A, masks)

    return fn


def _parallel_posteriors(layout: ChainLayout, A, masks):
    blocks = list(A) if isinstance(A, (list, tuple)) else [A]
    dev0, dtype = blocks[0].device, blocks[0].dtype
    M = _stack_masks(layout, masks, dtype, dev0)    # [m+1, B, K]
    B, K = M.shape[1], M.shape[2]
    scans, lo = [], 0
    for blk in blocks:                               # independent per block
        hi = lo + blk.shape[0]
        Mb = M[lo:hi + 1].to(blk.device, non_blocking=True)
        zeros = torch.zeros((hi - lo, B), dtype=dtype, device=blk.device)
        fwd = _scan_products(Mb[:-1, :, :, None] * blk[:, None], zeros, False)
        bwd = _scan_products(blk[:, None] * Mb[1:, :, None, :], zeros, True)
        scans.append((fwd, bwd[0]))
        lo = hi
    ones = torch.ones((B, K), dtype=dtype, device=dev0)
    zero = torch.zeros((B,), dtype=dtype, device=dev0)
    # forward: carry F and its offset from each block's last step onward
    F, Foff = [ones[None]], [zero[None]]
    e, eoff = ones, zero
    for blk, ((L, S), _) in zip(blocks, scans):
        d = blk.device
        f = torch.matmul(e.to(d)[:, None, :], L)[:, :, 0]     # [nb, B, K]
        c = f.amax(dim=-1).clamp_min(_TINY)
        f, off = f / c[..., None], S + eoff.to(d) + torch.log(c)
        e, eoff = f[-1].to(dev0), off[-1].to(dev0)
        F.append(f.to(dev0, non_blocking=True))
        Foff.append(off.to(dev0, non_blocking=True))
    # backward: G scales cancel in the posteriors, so no offsets
    G, g = [ones[None]], ones
    for blk, (_, Lb) in zip(reversed(blocks), reversed(scans)):
        gb = torch.matmul(Lb, g.to(blk.device)[:, :, None])[..., 0]
        gb = gb / gb.amax(dim=-1, keepdim=True).clamp_min(_TINY)
        g = gb[0].to(dev0)
        G.insert(0, gb.to(dev0, non_blocking=True))
    F, Foff, G = torch.cat(F), torch.cat(Foff), torch.cat(G)
    post = F * M * G
    post = post / post.sum(dim=-1, keepdim=True).clamp_min(_TINY)
    zfin = (F[-1] * M[-1]).sum(dim=-1)
    logz = torch.where(
        zfin > 0, torch.log(zfin.clamp_min(_TINY)),
        torch.full_like(zfin, -float("inf")),
    ) + Foff[-1]
    return post, logz


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
    [m+1, B, K] posterior tensor, and an HMM's leaves (``leaves``: var id
    -> (its group's stacked [Lg, B, C] posteriors, its row there)).
    Behaves like the list of tensors the general program returns
    (``post[var_id]`` -> [B, card])."""

    def __init__(self, stacked: torch.Tensor, var_order: Sequence[int],
                 leaves: Optional[Dict[int, Tuple[torch.Tensor, int]]] = None):
        self._stacked = stacked
        self.var_order = list(var_order)
        self._pos: Dict[int, int] = {v: k for k, v in enumerate(var_order)}
        self._leaves = leaves or {}

    @property
    def stacked(self) -> torch.Tensor:
        return self._stacked

    def __len__(self) -> int:
        return len(self._pos) + len(self._leaves)

    def __getitem__(self, var_id: int) -> torch.Tensor:
        if var_id in self._leaves:
            stack, row = self._leaves[var_id]
            return stack[row]
        return self._stacked[self._pos[var_id]]

    def __iter__(self):
        for v in range(len(self)):
            yield self[v]

    @classmethod
    def cat(cls, parts: Sequence["StackedPosteriors"],
            device) -> "StackedPosteriors":
        """``parts`` (one program's results on row blocks) joined along
        their batch axis on ``device``, the hidden stack and each leaf
        group's stack alike."""
        first = parts[0]
        groups: Dict[int, torch.Tensor] = {}
        leaves = {}
        for v, (stack, row) in first._leaves.items():
            if id(stack) not in groups:
                groups[id(stack)] = torch.cat(
                    [p._leaves[v][0].to(device) for p in parts], dim=1)
            leaves[v] = (groups[id(stack)], row)
        return cls(torch.cat([p.stacked.to(device) for p in parts], dim=1),
                   first.var_order, leaves)
