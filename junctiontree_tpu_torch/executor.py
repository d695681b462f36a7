"""Execute phase: static-schedule belief propagation in PyTorch.

Counterpart of ``junctiontree_tpu/executor.py``.  The collect/distribute
schedule is unrolled over the rooted tree (``Plan.tree.topo_order``) into a
static sequence of contractions; clique potentials are broadcast to full
clique scope; distribute recomputes leave-one-out products (no division, so
structural zeros are safe); evidence is a per-variable mask combined into
one clique per variable (``Plan.var_to_clique``).

Every function takes the semiring (sum-product, log-sum-exp, max-product;
``ops/semirings.py``).  Two paths:

* the parity path (``propagate_cliques``; ``Engine.propagate``,
  ``Engine.query`` and the batched ``Engine.query_batch``), which every
  serving result is checked against;
* the serving path ``Engine.posterior_batch``.  Its general program is the
  batch-aware message program built by :class:`BatchedProgramBuilder`
  (rescaled for sum-product, optionally stored in bfloat16): clique
  potentials stay unbatched and only masks and messages carry the batch
  axis; large sum-product cliques go through the factored big-clique
  contraction (the CUDA kernel on the card, ``ops/factored_contract.py``),
  everything else through the semiring's planned contraction.  In auto mode
  uniform chains and hidden Markov models (a uniform chain with leaves)
  take the forward-backward programs of ``scan_executor.py`` and regular
  models of many small cliques the level-fused program of ``fused.py``.

PyTorch runs eagerly, so there is no jit and no program cache beyond the
builder's static schedule.
"""

from __future__ import annotations

import math
import weakref
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import DEFAULT as _CFG
from .ops.factored_contract import big_clique_sep_message
from .parallel.mesh import MODEL_AXIS, Sharding, row_blocks
from .parallel.tp import ShardedPotential, tp_contract_fn
from .ops.semirings import (
    _LOW_PRECISION,
    LOG_SUM_EXP,
    MAX_PRODUCT,
    SEMIRINGS,
    SUM_PRODUCT,
    Semiring,
    _broadcast_to_scope,
)
from .schedule import Plan
from .utils.timing import TIMERS


def _combine_into_scope(
    semiring: Semiring,
    acc: torch.Tensor,
    scope: Sequence[int],
    x: torch.Tensor,
    x_vars: Sequence[int],
) -> torch.Tensor:
    return semiring.combine(acc, _broadcast_to_scope(x, x_vars, scope))


# exact inference materializes every clique's state space; beyond this limit
# the model's treewidth makes junction-tree inference infeasible on any
# engine, so fail fast with a diagnostic instead of hanging on a huge alloc
MAX_CLIQUE_STATES = 1 << 28


def check_feasible(plan: Plan, max_states: Optional[int] = None) -> None:
    cap = MAX_CLIQUE_STATES if max_states is None else max_states
    worst = 0
    for c in range(plan.tri.num_cliques):
        states = 1
        for v in plan.tri.maxcliques[c]:
            states *= plan.sizes[v]
        worst = max(worst, states)
    if worst > cap:
        raise ValueError(
            "model is infeasible for exact inference: largest clique has "
            f"{worst:,} states (treewidth {plan.tri.treewidth}); limit is "
            f"{cap:,}. Reduce the model's connectivity or use a better "
            "elimination order (heuristic='portfolio16')."
        )


def evaluate_cliques(
    plan: Plan,
    factor_values: Sequence[torch.Tensor],
    semiring: Semiring = SUM_PRODUCT,
    max_states: Optional[int] = None,
) -> List[torch.Tensor]:
    """Initial clique potentials on the tensors' device: product of the
    assigned factors, broadcast to the full clique shape (Hugin
    initialization).  ``factor_values`` are in the semiring's space already
    (use ``semiring.from_linear`` at the boundary)."""
    check_feasible(plan, max_states)
    if len(factor_values) != len(plan.factors):
        raise ValueError(
            "expected %d factor value arrays, got %d"
            % (len(plan.factors), len(factor_values))
        )
    for f, (fvars, val) in enumerate(zip(plan.factors, factor_values)):
        want = plan.factor_shape(f)
        if tuple(val.shape) != want:
            raise ValueError(
                "factor %d (vars %r) has shape %r, expected %r"
                % (f, plan.table.labels_of(fvars), tuple(val.shape), want)
            )
    if factor_values:
        ref = factor_values[0]
        dtype = ref.dtype
        for val in factor_values[1:]:
            dtype = torch.promote_types(dtype, val.dtype)
        device = ref.device
    else:
        dtype, device = torch.float32, None
    pots = [
        torch.full(plan.clique_shape(c), semiring.one, dtype=dtype, device=device)
        for c in range(plan.tri.num_cliques)
    ]
    for f, (fvars, val) in enumerate(zip(plan.factors, factor_values)):
        c = plan.tri.factor_to_maxclique[f]
        if c < 0:  # empty-scope (scalar) factor folds into the root clique
            c = plan.tree.root
            pots[c] = semiring.combine(pots[c], val)
            continue
        pots[c] = _combine_into_scope(
            semiring, pots[c], plan.clique_vars[c], val, fvars
        )
    return pots


def evaluate_cliques_np(
    plan: Plan,
    factor_values: Sequence[np.ndarray],
    semiring: Semiring = SUM_PRODUCT,
    dtype=np.float64,
    max_states: Optional[int] = None,
) -> List[np.ndarray]:
    """Host-side NumPy clique evaluation (same math as
    :func:`evaluate_cliques`): one-time elementwise work per
    ``set_potentials``, done where the factor values already are."""
    check_feasible(plan, max_states)
    if len(factor_values) != len(plan.factors):
        raise ValueError(
            "expected %d factor value arrays, got %d"
            % (len(plan.factors), len(factor_values))
        )
    pots: List[np.ndarray] = []
    for c in range(plan.tri.num_cliques):
        pots.append(np.full(plan.clique_shape(c), semiring.one, dtype=dtype))
    for f, (fvars, val) in enumerate(zip(plan.factors, factor_values)):
        val = np.asarray(val, dtype=dtype)
        want = plan.factor_shape(f)
        if tuple(val.shape) != want:
            raise ValueError(
                "factor %d (vars %r) has shape %r, expected %r"
                % (f, plan.table.labels_of(fvars), tuple(val.shape), want)
            )
        c = plan.tri.factor_to_maxclique[f]
        if c < 0:  # empty-scope (scalar) factor folds into the root clique
            c = plan.tree.root
            pots[c] = (pots[c] + val) if semiring.is_log else (pots[c] * val)
            continue
        cvars = plan.clique_vars[c]
        pos = {v: i for i, v in enumerate(fvars)}
        perm = [pos[v] for v in cvars if v in pos]
        x = np.transpose(val, perm)
        shape = [(plan.sizes[v] if v in pos else 1) for v in cvars]
        x = x.reshape(shape)
        pots[c] = (pots[c] + x) if semiring.is_log else (pots[c] * x)
    return pots


def apply_masks(
    plan: Plan,
    clique_pots: Sequence[torch.Tensor],
    masks: Sequence[torch.Tensor],
    semiring: Semiring = SUM_PRODUCT,
) -> List[torch.Tensor]:
    """Combine per-variable evidence masks (semiring space, one [size_v]
    vector per variable id) into each variable's designated clique."""
    pots = list(clique_pots)
    for v, m in enumerate(masks):
        c = plan.var_to_clique[v]
        pots[c] = _combine_into_scope(
            semiring, pots[c], plan.clique_vars[c], m, [v]
        )
    return pots


def propagate_cliques(
    plan: Plan,
    clique_pots: Sequence[torch.Tensor],
    semiring: Semiring = SUM_PRODUCT,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Two-pass collect/distribute over the static schedule.

    Returns (clique_beliefs, sep_beliefs): unnormalized joint marginals over
    each clique's / separator's variables."""
    tree = plan.tree
    cvars = plan.clique_vars
    svars = plan.sep_vars

    # ---- collect: leaves -> root; up[c] lives on the edge (c -> parent) ----
    up: List[Optional[torch.Tensor]] = [None] * tree.num_cliques
    for c in reversed(tree.topo_order):
        if c == tree.root:
            continue
        operands = [clique_pots[c]]
        operand_vars: List[Sequence[int]] = [cvars[c]]
        for child, sep in tree.children[c]:
            operands.append(up[child])
            operand_vars.append(svars[sep])
        up[c] = semiring.contract(
            operands, operand_vars, svars[tree.parent_sep[c]]
        )

    # ---- distribute: root -> leaves; down[c] lives on the same edge ----
    # For parent p with children k_1..k_d, the message to k_i needs the
    # product of pot_p, down[p], and up[k_j] for j != i: prefix/suffix
    # combines over the children broadcast to p's scope, O(d) combines.
    down: List[Optional[torch.Tensor]] = [None] * tree.num_cliques
    for p in tree.topo_order:
        kids = tree.children[p]
        if not kids:
            continue
        acc = clique_pots[p]
        if p != tree.root:
            acc = _combine_into_scope(
                semiring, acc, cvars[p], down[p], svars[tree.parent_sep[p]]
            )
        d = len(kids)
        bcast = [
            _broadcast_to_scope(up[k], svars[s], cvars[p]) for k, s in kids
        ]
        if d == 1:
            k, s = kids[0]
            down[k] = semiring.contract([acc], [cvars[p]], svars[s])
            continue
        prefix: List[Optional[torch.Tensor]] = [None] * d
        suffix: List[Optional[torch.Tensor]] = [None] * d
        run = None
        for i in range(d):
            prefix[i] = run
            run = bcast[i] if run is None else semiring.combine(run, bcast[i])
        run = None
        for i in range(d - 1, -1, -1):
            suffix[i] = run
            run = bcast[i] if run is None else semiring.combine(run, bcast[i])
        for i, (k, s) in enumerate(kids):
            loo = acc
            if prefix[i] is not None:
                loo = semiring.combine(loo, prefix[i])
            if suffix[i] is not None:
                loo = semiring.combine(loo, suffix[i])
            down[k] = semiring.contract([loo], [cvars[p]], svars[s])

    # ---- beliefs ----
    clique_beliefs: List[Optional[torch.Tensor]] = [None] * tree.num_cliques
    for c in tree.topo_order:
        acc = clique_pots[c]
        if c != tree.root:
            acc = _combine_into_scope(
                semiring, acc, cvars[c], down[c], svars[tree.parent_sep[c]]
            )
        for k, s in tree.children[c]:
            acc = _combine_into_scope(semiring, acc, cvars[c], up[k], svars[s])
        clique_beliefs[c] = acc

    sep_beliefs: List[Optional[torch.Tensor]] = [None] * len(svars)
    for c in tree.topo_order:
        if c == tree.root:
            continue
        s = tree.parent_sep[c]
        sep_beliefs[s] = semiring.combine(up[c], down[c])

    return clique_beliefs, sep_beliefs


def factor_marginals(
    plan: Plan,
    clique_beliefs: Sequence[torch.Tensor],
    semiring: Semiring = SUM_PRODUCT,
) -> List[torch.Tensor]:
    """Project consistent clique beliefs back onto each factor's variables.
    Empty-scope factors marginalize the root belief to a scalar (= Z)."""
    out: List[torch.Tensor] = []
    for f, fvars in enumerate(plan.factors):
        c = plan.tri.factor_to_maxclique[f]
        if c < 0:
            c = plan.tree.root
        out.append(
            semiring.contract([clique_beliefs[c]], [plan.clique_vars[c]], fvars)
        )
    return out


def var_marginals(
    plan: Plan,
    clique_beliefs: Sequence[torch.Tensor],
    semiring: Semiring = SUM_PRODUCT,
) -> List[torch.Tensor]:
    """Per-variable unnormalized marginals, one [size_v] vector per var id."""
    out: List[torch.Tensor] = []
    for v in range(plan.num_vars):
        c = plan.var_to_clique[v]
        out.append(
            semiring.contract([clique_beliefs[c]], [plan.clique_vars[c]], [v])
        )
    return out


def partition(
    plan: Plan,
    clique_beliefs: Sequence[torch.Tensor],
    semiring: Semiring = SUM_PRODUCT,
) -> torch.Tensor:
    """Normalization constant: the root belief fully marginalized."""
    r = plan.tree.root
    return semiring.contract([clique_beliefs[r]], [plan.clique_vars[r]], [])


def all_ones_masks(plan: Plan, semiring: Semiring = SUM_PRODUCT) -> List[np.ndarray]:
    """No-evidence masks (semiring space)."""
    return [np.full((s,), semiring.one, dtype=np.float32) for s in plan.sizes]


def evidence_to_masks(
    plan: Plan,
    evidence: Dict[Hashable, int],
    semiring: Semiring = SUM_PRODUCT,
) -> List[np.ndarray]:
    """Dict {var label: observed state} -> per-variable mask vectors:
    entries inconsistent with the evidence become the semiring zero."""
    masks = all_ones_masks(plan, semiring)
    for label, state in evidence.items():
        if label not in plan.table:
            raise KeyError(
                "evidence variable %r is not a variable of this model" % (label,)
            )
        v = plan.table.id_of(label)
        if not 0 <= int(state) < plan.sizes[v]:
            raise ValueError(
                "evidence state %r out of range for variable %r (size %d)"
                % (state, label, plan.sizes[v])
            )
        m = np.full((plan.sizes[v],), semiring.zero, dtype=np.float32)
        m[int(state)] = semiring.one
        masks[v] = m
    return masks


# ---------------------------------------------------------------------------
# Batch-aware propagation program.
#
# Clique potentials stay UNBATCHED; only masks and messages carry the batch
# axis, so each contraction mixes unbatched and batched operands and the
# planned einsum sums out non-separator variables of the potential before
# touching the batch axis.  Subtrees with no evidence anywhere stay entirely
# unbatched (computed once, shared by the batch).
# ---------------------------------------------------------------------------

BATCH = -1  # pseudo variable id for the evidence-batch axis


def _vars_states(sizes, vs):
    """State count of a var scope (ignoring the batch pseudo-var)."""
    n = 1
    for v in vs:
        if v != BATCH:
            n *= sizes[v]
    return n


def _bcontract(semiring, operands, operand_vars, out_vars):
    """Contract mixed batched/unbatched operands; output gets the batch axis
    iff any operand has it.  Counted in ``route.einsum_calls``; a recorded
    call notes the contraction's logical shape on its ``route.einsum`` span
    (:func:`_einsum_shape`)."""
    batched = any(vs and vs[0] == BATCH for vs in operand_vars)
    out = ([BATCH] + list(out_vars)) if batched else list(out_vars)
    TIMERS.add("route.einsum_calls")
    with TIMERS.span("route.einsum"):
        y = semiring.contract(operands, operand_vars, out)
        if TIMERS.recording():
            TIMERS.note(**_einsum_shape(operands, operand_vars, y))
        return y, batched


def _einsum_shape(operands, operand_vars, y) -> dict:
    """What a planned contraction has to do, whatever implements it: ``B``
    the batch (1 unbatched), ``states`` the product's states per row over
    the union of the operands' scopes, ``bytes`` the operands' logical
    bytes plus the output's."""
    B, extent = 1, {}
    for x, vs in zip(operands, operand_vars):
        for d, v in zip(x.shape, vs):
            if v == BATCH:
                B = int(d)
            else:
                extent[v] = int(d)
    states = 1
    for d in extent.values():
        states *= d
    nbytes = sum(x.numel() * x.element_size() for x in operands)
    return {"B": B, "states": states,
            "bytes": nbytes + y.numel() * y.element_size()}


def _try_big_clique_route(plan, semiring, ops, ovs, out_vars, min_states,
                          tp=None):
    """Route a collect/distribute/marginal contraction through the factored
    big-clique contraction when the semiring is sum-product, the clique has
    at least ``min_states`` states and every batched operand is either a
    single-variable mask (evidence) or a child message whose scope doesn't
    cross the output-separator boundary.  Returns (result, batched) or
    None.

    ``tp = (mesh, tp_min_states, shard_batch, notes, device)`` (an
    ``Engine.shard_model`` engine) also routes every clique of at least
    ``tp_min_states`` states through the contraction sharded over the
    mesh's model axis (``parallel.tp.tp_contract_fn``), whether or not a
    batched operand touches it: without one, it runs at a unit batch of
    ones weights, so a sharded potential is never assembled on one device.
    A TP-sized contraction that cannot be factored (a message crosses the
    separator boundary) falls to :func:`routed_contract`, which gathers the
    potential onto ``device``; the reason goes to ``notes``
    (``Engine.describe()["tp_fallbacks"]``)."""
    if semiring != SUM_PRODUCT:
        return None
    batched: List[tuple] = []
    msgs: List[tuple] = []
    unbatched: List[tuple] = []
    for o, v in zip(ops, ovs):
        if v and v[0] == BATCH:
            if len(v) == 2:
                batched.append((o, v[1]))
            else:
                msgs.append((tuple(v[1:]), o))
        else:
            unbatched.append((o, list(v)))
    if not unbatched:
        return None
    scope: List[int] = []
    for _, v in unbatched:
        for x in v:
            if x not in scope:
                scope.append(x)
    states = _vars_states(plan.sizes, scope)
    tp_sized = tp is not None and states >= tp[1]

    def refuse(reason):
        if states >= min_states and (batched or msgs):
            TIMERS.add("big_clique_sep_message.refused")
        if tp_sized:
            tp[3].append(
                f"TP fallback (gathered onto one device) on {states:,}-state "
                f"scope {scope} -> {list(out_vars)}: {reason}"
            )

    if not tp_sized and (states < min_states or not (batched or msgs)):
        return None
    if any(x not in scope for x in out_vars):
        return refuse("output variables outside the unbatched scope")
    if any(x not in scope for _, x in batched):
        return refuse("evidence mask outside the unbatched scope")
    out_set = set(out_vars)
    for vs, _ in msgs:
        if any(x not in scope for x in vs):
            return refuse(f"message scope {vs} outside the unbatched scope")
        # a message must factor entirely into the kernel weights (rest
        # scope) or entirely into the output (separator scope)
        if not (all(x in out_set for x in vs)
                or all(x not in out_set for x in vs)):
            return refuse(f"message scope {vs} crosses the separator boundary")
    contract_fn = None
    squeeze = False
    if tp_sized:
        shard_batch = tp[2]
        if not (batched or msgs):
            rest0 = [x for x in scope if x not in out_set]
            if not rest0:
                return refuse("contraction reduces nothing (scope == output)")
            batched = [(torch.ones((1, plan.sizes[rest0[0]]),
                                   dtype=torch.float32, device=tp[4]),
                        rest0[0])]
            squeeze, shard_batch = True, False
        contract_fn = tp_contract_fn(tp[0], shard_batch=shard_batch)
    pot = unbatched[0][0]
    if isinstance(pot, ShardedPotential):
        # the clique's potential comes first, so the scope is its variables;
        # its unbatched messages are multiplied in block by block
        pot = pot.times([(o, [scope.index(x) for x in v])
                         for o, v in unbatched[1:]])
    elif not (len(unbatched) == 1 and unbatched[0][1] == scope):
        # the clique potential times its unbatched messages, stored like the
        # potential (under bfloat16 storage the kernel reads bfloat16)
        pot = semiring.contract(
            [o for o, _ in unbatched], [v for _, v in unbatched], scope
        ).to(pot.dtype)
    masks: Dict[int, torch.Tensor] = {}
    for o, x in batched:
        masks[x] = o if x not in masks else masks[x] * o
    with TIMERS.span("route.big_clique", states=states):
        out = big_clique_sep_message(pot, scope, masks, list(out_vars),
                                     msgs=msgs, contract_fn=contract_fn)
    if squeeze:
        return out[0], False
    return out, True


def routed_contract(plan, semiring, ops, ovs, outv, *, min_states, tp=None):
    """One contraction through the routing ladder: the factored big-clique
    contraction, else the semiring's planned batched contraction (on a
    model-sharded engine with any sharded potential gathered onto the
    engine's device first).  Returns (result, batched)."""
    routed = _try_big_clique_route(
        plan, semiring, ops, ovs, outv, min_states, tp=tp)
    if routed is not None:
        return routed
    if tp is not None:
        ops = [o.gather() if isinstance(o, ShardedPotential) else o
               for o in ops]
    return _bcontract(semiring, ops, ovs, outv)


def make_contract(plan, semiring):
    """Routed-contraction closure with the current config's threshold:
    ``contract(ops, ovs, outv) -> (result, batched)``.  The lightweight face
    of ``BatchedProgramBuilder._contract`` for program builders that only
    need contractions, not a step schedule (``incremental.py``'s collect and
    delta programs)."""
    from functools import partial

    return partial(
        routed_contract, plan, semiring,
        min_states=_CFG.big_clique_min_states,
    )


def divide_project(
    semiring: Semiring,
    belief: torch.Tensor,
    belief_vars: Sequence[int],
    msg: torch.Tensor,
    msg_vars: Sequence[int],
) -> torch.Tensor:
    """Hugin division trick: ``reduce(belief / msg -> msg_vars)``.

    ``belief`` is a clique belief over ``belief_vars`` (maybe batched),
    ``msg`` the child's collect message over ``msg_vars``, a subset of
    ``belief_vars`` (an unbatched msg divides a batched belief by
    broadcast).  Returns the distribute message to that child over exactly
    ``msg_vars``, batched iff the belief is.  The belief is reduced to the
    separator first and divided there (the divisor is constant over the
    reduced axes).  Where the divisor is the semiring zero the result is the
    semiring zero: the child's belief is zero there too, so nothing
    downstream sees the difference.  Only for semirings whose product has an
    inverse (sum-product, log-sum-exp)."""
    b_batched = bool(belief_vars) and belief_vars[0] == BATCH
    m_batched = bool(msg_vars) and msg_vars[0] == BATCH
    if m_batched and not b_batched:
        raise ValueError("a batched message cannot divide an unbatched belief")
    lead = 1 if b_batched else 0
    bvars = list(belief_vars[lead:])
    mvars = list(msg_vars[1:] if m_batched else msg_vars)
    mset = set(mvars)
    sep = semiring.reduce(
        belief, [lead + i for i, v in enumerate(bvars) if v not in mset]
    )
    kept = [v for v in bvars if v in mset]
    # the divisor in the reduced belief's axis order, leading 1 to broadcast
    mlead = 1 if m_batched else 0
    m = msg.permute(
        list(range(mlead)) + [mlead + mvars.index(v) for v in kept]
    )
    if b_batched and not m_batched:
        m = m[None]
    # the quotient where the divisor is the semiring zero (inf or NaN) is
    # replaced, never read
    out = torch.where(
        m == semiring.zero, semiring.zero, semiring.divide(sep, m)
    )
    return out.permute(
        list(range(lead)) + [lead + kept.index(v) for v in mvars]
    )


_PROG_TINY = 1e-38


def clique_mask_vars(plan: Plan, observed: Sequence[int]) -> List[List[int]]:
    """Per clique, the observed variables whose mask it absorbs (each
    variable's mask goes to the one clique ``plan.var_to_clique`` names)."""
    out: List[List[int]] = [[] for _ in range(plan.tree.num_cliques)]
    for v in observed:
        out[plan.var_to_clique[v]].append(v)
    return out


class BatchedProgramBuilder:
    """Step-structured construction of the batch-aware propagate program.

    The program is a STATIC schedule of steps — one collect contraction per
    non-root clique, one distribute step per parent, one marginal per
    variable, one partition step — over a dict of named tensors.  Whether
    each intermediate carries the batch axis is decided statically (a
    contraction output is batched iff any operand is batched), and every
    contraction checks it.  ``full()`` returns the program as a function.

    ``rescale=True`` (linear sum-product only): every message is divided by
    its max and the collect offsets accumulate into logZ.  With
    ``headroom=True`` as well (the serving program, whose marginal and
    partition steps alone read the messages) the messages are scaled into
    the dtype's headroom instead (:meth:`_collect_scale`,
    :meth:`_distribute_scale`), which the entropy and joint programs, which
    multiply further factors into them, leave out.  The program then
    follows the potentials' dtype as its storage dtype: with bfloat16
    potentials the rescaled messages are stored in bfloat16 too, while
    contractions accumulate in float32, maxima and the floor are taken in
    float32 before the store, and logZ and the marginals come out float32.
    The masks stay as they are given (float32): they are [B, size_v], small
    beside the messages, and every contraction would widen them again.

    With ``config.DEFAULT.distribute_division`` set (read here, once) the
    distribute pass of sum-product and log-sum-exp programs derives each
    child's message from the parent's belief by one guarded divide at
    separator size (:func:`divide_project`) instead of a leave-one-out
    product, on cliques small enough that the belief is materialized anyway;
    the marginal phase then reuses that belief."""

    def __init__(
        self,
        plan: Plan,
        semiring: Semiring = SUM_PRODUCT,
        observed: Optional[Sequence[int]] = None,
        rescale: bool = False,
        tp=None,
        headroom: bool = False,
    ):
        if rescale and semiring != SUM_PRODUCT:
            raise ValueError(
                "rescale=True requires the linear sum_product semiring"
            )
        self.plan = plan
        self.semiring = semiring
        self.rescale = rescale
        # one clique has no message to scale
        self.headroom = headroom and rescale and plan.tree.num_cliques > 1
        self.tp = tp
        tree = plan.tree
        if observed is None:
            observed = list(range(plan.num_vars))
        self.observed = list(observed)
        self.mask_slot = {v: i for i, v in enumerate(self.observed)}
        self.clique_mask_vars = clique_mask_vars(plan, self.observed)
        self.min_states = _CFG.big_clique_min_states
        self.divide_ok = _CFG.distribute_division and semiring in (
            SUM_PRODUCT, LOG_SUM_EXP
        )
        # cliques up to this size materialize their belief once in the
        # marginal phase; bigger ones contract per variable so
        # [B, clique_states] never materializes
        self.BELIEF_STATES_CAP = 1 << 12
        self._flags()
        # the collect pass, leaves first, and the partition at the root;
        # then, root first, each clique's distribute step and the marginals
        # of the variables it homes, so that a clique's messages are done
        # with as the pass leaves it
        homed: Dict[int, List[int]] = {}
        for v in range(plan.num_vars):
            homed.setdefault(plan.var_to_clique[v], []).append(v)
        self.steps = [("up", c) for c in reversed(tree.topo_order)
                      if c != tree.root] + [("z", None)]
        for p in tree.topo_order:
            if tree.children[p]:
                self.steps.append(("down", p))
            self.steps += [("marg", v) for v in homed.get(p, [])]
        self._dropped = None
        self._room_kept = None

    def _states(self, c: int) -> int:
        return _vars_states(self.plan.sizes, self.plan.clique_vars[c])

    def _divide_path(self, p: int) -> bool:
        return self.divide_ok and self._states(p) <= self.BELIEF_STATES_CAP

    def _flags(self) -> None:
        """Static batch-ness of every intermediate."""
        tree = self.plan.tree
        has_mask = [bool(m) for m in self.clique_mask_vars]
        up_b: Dict[int, bool] = {}
        for c in reversed(tree.topo_order):
            if c == tree.root:
                continue
            up_b[c] = has_mask[c] or any(up_b[k] for k, _ in tree.children[c])
        down_b: Dict[int, bool] = {}
        for p in tree.topo_order:
            kids = tree.children[p]
            if not kids:
                continue
            base = has_mask[p] or (p != tree.root and down_b[p])
            if self._divide_path(p):
                # every child's message comes from the one belief
                b = base or any(up_b[k] for k, _ in kids)
                for k, _ in kids:
                    down_b[k] = b
            else:
                for i, (k, _) in enumerate(kids):
                    down_b[k] = base or any(
                        up_b[k2] for j, (k2, _) in enumerate(kids) if j != i
                    )
        node_b: Dict[int, bool] = {}
        for c in range(tree.num_cliques):
            node_b[c] = has_mask[c] or (
                c != tree.root and down_b.get(c, False)
            ) or any(up_b[k] for k, _ in tree.children[c])
        self.up_b = up_b
        self.down_b = down_b
        self.node_b = node_b

    def _contract(self, ops, ovs, outv):
        out, b = routed_contract(
            self.plan, self.semiring, ops, ovs, outv,
            min_states=self.min_states, tp=self.tp,
        )
        expect_b = any(vs and vs[0] == BATCH for vs in ovs)
        if b != expect_b:
            raise AssertionError(
                "static batch flag mismatch (got %r, expected %r) on "
                "contraction -> %r" % (b, expect_b, list(outv))
            )
        return out, b

    def _clique_ops(self, c, pots, masks):
        ops = [pots[c]]
        ovs: List[List[int]] = [list(self.plan.clique_vars[c])]
        for v in self.clique_mask_vars[c]:
            ops.append(masks[self.mask_slot[v]])
            ovs.append([BATCH, v])
        return ops, ovs

    def _msg_max(self, m, batched):
        """The message's maximum (per batch row when batched), floored, in
        the contraction's dtype, shaped to divide it."""
        if batched:
            s = m.reshape(m.shape[0], -1).amax(dim=1).clamp_min(_PROG_TINY)
            return s.reshape((-1,) + (1,) * (m.dim() - 1))
        return m.max().clamp_min(_PROG_TINY)

    def _room(self, pots, dtype) -> List[float]:
        """Per clique c, the headroom H_c of its contractions in ``dtype``:
        log(largest value) - 1 - log(c's states) - log(max of c's
        potential), at least 0.  Every other operand at most e^h, with the
        h adding up to H_c, keeps every partial product of c's contractions
        finite.  Read from the potentials once (one host sync) and kept
        while they are the same tensors at the same version."""
        key = [(id(x), None if not isinstance(x, torch.Tensor)
                or x.is_inference() else x._version) for x in pots]
        if self._room_kept is not None:
            refs, was, room = self._room_kept
            if was == key and None not in (k[1] for k in key) and all(
                    r() is x for r, x in zip(refs, pots)):
                return room
        top = math.log(torch.finfo(dtype).max) - 1.0
        dense = [x for x in pots if isinstance(x, torch.Tensor)
                 and x.device.type != "meta"]
        peaks = iter(torch.stack([x.detach().amax().double() for x in dense])
                     .cpu().tolist() if dense else [])
        room = []
        for c, x in enumerate(pots):
            if isinstance(x, torch.Tensor):
                peak = next(peaks) if x.device.type != "meta" else 1.0
            else:  # a ShardedPotential: its host copy
                peak = float(x.host.max())
            big = top - math.log(self._states(c))
            room.append(min(max(big - math.log(peak), 0.0), big)
                        if peak > 0 else big)
        self._room_kept = ([weakref.ref(x) for x in pots], key, room)
        return room

    def _collect_scale(self, st, c, m, batched, pots, storage):
        """Scale the collect message of ``c`` so that its max is e^X, X its
        share of the parent's headroom (:meth:`_room`): the whole of it
        split over the root's children, three quarters of it over another
        parent's, whose distribute message takes the rest.  A message holds
        its entries down to float32's least normal value, e^-87, below its
        max: one divided to a max of one would lose those that the other
        side of a frustrated lattice makes count (e^-130 and lower at the
        20 x 20 Ising lattice's separators, where the evidence pulls the
        two sides apart).  log(max) - X goes into the logZ offset and is
        kept as ``("logs", c)``.  The max and the scaling are in the
        contraction's dtype (float32 under low-precision storage); only the
        scaled message is stored in ``storage``.  Without ``headroom`` the
        message is divided by its max (X = 0)."""
        s = self._msg_max(m, batched)
        if not self.headroom:
            ls = torch.log(s.reshape(-1) if batched else s)
            st[("logoff",)] = st[("logoff",)] + ls
            return (m / s).to(storage)
        tree = self.plan.tree
        par = tree.parent[c]
        room = self._room(pots, s.dtype)[par]
        X = room * (1.0 if par == tree.root else 0.75) / len(
            tree.children[par])
        top = math.log(torch.finfo(s.dtype).max) - 1.0
        # a message of no mass (a row of impossible evidence) would take a
        # factor past the dtype's largest value
        lmax = torch.log(s.to(st[("logoff",)].dtype))
        e = (X - (lmax.reshape(-1) if batched else lmax)).clamp_max(top)
        st[("logoff",)] = st[("logoff",)] - e
        st[("logs", c)] = -e
        f = torch.exp(e).to(s.dtype)
        return (m * (f.reshape(s.shape) if batched else f)).to(storage)

    def _distribute_scale(self, st, p, k, m, batched, pots, storage):
        """Scale the distribute message ``p`` -> ``k`` so that ``k``'s
        belief sums to one, as far as the message's max stays between one
        and e^D, D the quarter of k's headroom its collect messages leave
        (all of it at a leaf), and keep the log of that belief's sum as
        ``("ell", k)``.

        The belief multiplies this message with k's collect messages: where
        the evidence pulls the two sides of a frustrated model apart, their
        product falls far below their maxima (e^-95 at the 20 x 20 Ising
        lattice's cliques with both divided to a max of one), under
        float32's least normal value, and the marginals drown.  The
        belief's sum is known without forming it: k's belief sums over k's
        separator to e^logs_k (``("logs", k)``) times the message times k's
        collect message, and that product sums to p's belief sum, so log
        sum = ell_p + logs_k - t for a message divided by e^t.  A message
        is never scaled below a max of one, which would cut its own
        entries' range.  An unbatched message keeps a max of one where p's
        sum is per row (a row scale would batch it).  Without ``headroom``
        the message is divided by its max."""
        s = self._msg_max(m, batched)
        if not self.headroom:
            return (m / s).to(storage)
        lmax = torch.log((s.reshape(-1) if batched else s).to(
            st[("logoff",)].dtype))
        # log of k's belief sum were the message divided by its own max
        g = st[("ell", p)] + st[("logs", k)] - lmax
        if not batched and g.dim() > 0:
            st[("ell", k)] = g
            return (m / s).to(storage)
        room = self._room(pots, s.dtype)[k]
        c = torch.clamp(g, -room * (0.25 if self.plan.tree.children[k]
                                    else 1.0), 0.0)
        st[("ell", k)] = g - c
        top = math.log(torch.finfo(s.dtype).max) - 1.0
        f = torch.exp((-(lmax + c)).clamp_max(top)).to(s.dtype)
        return (m * (f.reshape(s.shape) if batched else f)).to(storage)

    def _upv(self, c):
        tree = self.plan.tree
        return ([BATCH] if self.up_b[c] else []) + list(
            self.plan.sep_vars[tree.parent_sep[c]]
        )

    def _downv(self, c):
        tree = self.plan.tree
        return ([BATCH] if self.down_b[c] else []) + list(
            self.plan.sep_vars[tree.parent_sep[c]]
        )

    def _node_ops(self, c, st, pots, masks):
        tree = self.plan.tree
        ops, ovs = self._clique_ops(c, pots, masks)
        if c != tree.root:
            ops.append(st[("down", c)])
            ovs.append(self._downv(c))
        for k, _ in tree.children[c]:
            ops.append(st[("up", k)])
            ovs.append(self._upv(k))
        return ops, ovs

    def _run_step(self, s, st, pots, masks, B, storage):
        plan, tree = self.plan, self.plan.tree
        svars = plan.sep_vars
        kind, c = s
        if kind == "up":
            ops, ovs = self._clique_ops(c, pots, masks)
            for k, _ in tree.children[c]:
                ops.append(st[("up", k)])
                ovs.append(self._upv(k))
            out, b = self._contract(ops, ovs, svars[tree.parent_sep[c]])
            if self.rescale:
                out = self._collect_scale(st, c, out, b, pots, storage)
            st[("up", c)] = out
        elif kind == "down":
            p = c
            kids = tree.children[p]
            pops, povs = self._clique_ops(p, pots, masks)
            if p != tree.root:
                pops.append(st[("down", p)])
                povs.append(self._downv(p))
            if self._divide_path(p):
                if ("bel", p) not in st:
                    ops, ovs = list(pops), list(povs)
                    for k2, _ in kids:
                        ops.append(st[("up", k2)])
                        ovs.append(self._upv(k2))
                    st[("bel", p)], _ = self._contract(
                        ops, ovs, list(plan.clique_vars[p]))
                bel = st[("bel", p)]
                bb = self.node_b[p]
                belv = ([BATCH] if bb else []) + list(plan.clique_vars[p])
                for k, _ in kids:
                    out = divide_project(
                        self.semiring, bel, belv, st[("up", k)], self._upv(k)
                    )
                    if self.rescale:
                        out = self._distribute_scale(st, p, k, out, bb, pots,
                                                     storage)
                    st[("down", k)] = out
                return
            for i, (k, sep) in enumerate(kids):
                ops, ovs = list(pops), list(povs)
                for j, (k2, _) in enumerate(kids):
                    if j != i:
                        ops.append(st[("up", k2)])
                        ovs.append(self._upv(k2))
                out, b = self._contract(ops, ovs, svars[sep])
                if self.rescale:
                    out = self._distribute_scale(st, p, k, out, b, pots,
                                                 storage)
                st[("down", k)] = out
        elif kind == "marg":
            v = c
            cq = plan.var_to_clique[v]
            if self._states(cq) <= self.BELIEF_STATES_CAP:
                if ("bel", cq) not in st:
                    ops, ovs = self._node_ops(cq, st, pots, masks)
                    st[("bel", cq)], _ = self._contract(
                        ops, ovs, list(plan.clique_vars[cq])
                    )
                bv = ([BATCH] if self.node_b[cq] else []) + list(
                    plan.clique_vars[cq]
                )
                out, b = self._contract([st[("bel", cq)]], [bv], [v])
            else:
                ops, ovs = self._node_ops(cq, st, pots, masks)
                out, b = self._contract(ops, ovs, [v])
            if not b:
                out = out[None, :].expand(B, out.shape[0])
            st[("marg", v)] = out
        elif kind == "z":
            # at the root, before the distribute pass; a root small enough
            # keeps its belief for that pass and its marginals
            root = tree.root
            rops, rovs = self._node_ops(root, st, pots, masks)
            if self._states(root) <= self.BELIEF_STATES_CAP:
                st[("bel", root)], _ = self._contract(
                    rops, rovs, list(plan.clique_vars[root])
                )
                zv = ([BATCH] if self.node_b[root] else []) + list(
                    plan.clique_vars[root]
                )
                z, b = self._contract([st[("bel", root)]], [zv], [])
            else:
                z, b = self._contract(rops, rovs, [])
            if not b:
                z = z.reshape(()).expand(B)
            if self.rescale:
                # logZ = log(z_scaled) + accumulated collect offsets
                # (impossible evidence: z_scaled == 0 -> logZ = -inf);
                # log(z_scaled) is the log of the root's belief sum
                out = z.dtype
                z = z.to(st[("logoff",)].dtype)
                z = torch.where(
                    z > 0, torch.log(z.clamp_min(_PROG_TINY)),
                    torch.full_like(z, -float("inf")),
                )
                if self.headroom:
                    st[("ell", root)] = z if b else z[0]
                z = (z + st[("logoff",)].expand(z.shape)).to(out)
            st[("z",)] = z
        else:  # pragma: no cover
            raise AssertionError(kind)

    def _touches(self, s) -> List[tuple]:
        """The named tensors step ``s`` may read or write."""
        tree = self.plan.tree
        kind, c = s
        if kind == "up":
            return [("up", c), ("logs", c)] + [
                ("up", k) for k, _ in tree.children[c]]
        if kind == "marg":
            c = self.plan.var_to_clique[c]
        elif kind == "z":
            c = tree.root
        keys = [("up", k) for k, _ in tree.children[c]] + [("bel", c)]
        if c != tree.root:
            keys.append(("down", c))
        if kind == "z":
            keys.append(("ell", c))
        if kind == "down":
            keys.append(("ell", c))
            for k, _ in tree.children[c]:
                keys += [("down", k), ("logs", k), ("ell", k)]
        return keys

    def _drops(self) -> List[List[tuple]]:
        """Per step of the whole schedule, the messages and beliefs that no
        later step touches: a run of the whole schedule drops them after
        it, so a call holds the collect messages and the distribute
        frontier, not every message of both passes."""
        if self._dropped is None:
            last: Dict[tuple, int] = {}
            for i, s in enumerate(self.steps):
                for key in self._touches(s):
                    last[key] = i
            self._dropped = [[] for _ in self.steps]
            for key, i in last.items():
                self._dropped[i].append(key)
        return self._dropped

    def run(self, pots, masks, kinds=None) -> Dict[tuple, torch.Tensor]:
        """Run the schedule (only the steps whose kind is in ``kinds``, when
        given) and return the named tensors: ``("up", c)``, ``("down", c)``,
        ``("marg", v)``, ``("z",)``.  The message steps alone
        (``kinds=("up", "down", "z")``) are what the entropy and joint
        programs build on.  The whole schedule (``kinds=None``) drops each
        message and belief after its last step (:meth:`_drops`) and returns
        the marginals and z."""
        st: Dict[tuple, torch.Tensor] = {}
        drops = self._drops() if kinds is None else None
        B = masks[0].shape[0] if masks else 1
        storage = pots[0].dtype
        if self.rescale:
            # the headroom puts each collect offset at tens of nats, where
            # float32 would round every one of them: float64 then
            st[("logoff",)] = torch.zeros(
                (),
                dtype=torch.float32 if storage in _LOW_PRECISION
                else torch.float64 if self.headroom else storage,
                device=pots[0].device,
            )
        for i, s in enumerate(self.steps):
            if kinds is None or s[0] in kinds:
                # at: the clique (up, down) or the variable (marg)
                with TIMERS.span("program.step", kind=s[0], at=s[1]):
                    self._run_step(s, st, pots, masks, B, storage)
            if drops is not None:
                for key in drops[i]:
                    st.pop(key, None)
        return st

    def full(self):
        """``fn(pots, masks) -> (marginals list, z [B])``: marginals and z
        in semiring space; with ``rescale`` the marginals are unnormalized
        but bounded and z is logZ."""

        def fn(pots: Sequence[torch.Tensor], masks: Sequence[torch.Tensor]):
            st = self.run(pots, masks)
            margs = [st[("marg", v)] for v in range(self.plan.num_vars)]
            return margs, st[("z",)]

        return fn


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    """x log x, 0 at 0 (never 0 * -inf)."""
    return torch.where(x > 0, x * torch.log(x.clamp_min(_PROG_TINY)), 0.0)


def batched_entropy_program(plan: Plan, observed: Optional[Sequence[int]] = None):
    """Build ``fn(pots, masks) -> (entropies [B], Z [B] linear)``: the
    batch-aware posterior-entropy program (linear sum_product, rescaled).

    H(P) = sum_C H(b_C) - sum_S H(b_S) on the calibrated tree.  The routed
    batch-aware up/down message program runs ONCE, and each belief entropy
    is computed WITHOUT materializing the belief: with b = prod_i op_i,

        sum_x b log b = sum_i contract(ops with op_i -> op_i*log(op_i))

    so every term is a routed contraction to a scalar per element (on a big
    clique: the factored big-clique contraction with C = 1, once per
    operand and once more for the plain sum), and H(b) = log S1 - S2/S1
    with S1 = contract(ops -> []).  Per-element message rescaling only
    scales b by a per-element constant, which cancels in H (entropy of the
    NORMALIZED belief).  Structural zeros are safe: op*log(op) is 0 at 0
    and every other factor is finite.

    Impossible evidence yields H = 0 and Z = 0 for that element."""
    builder = BatchedProgramBuilder(plan, SUM_PRODUCT, observed, rescale=True)
    tree = plan.tree

    def fn(pots, masks):
        B = int(masks[0].shape[0]) if masks else 1
        st = builder.run(pots, masks, kinds=("up", "down", "z"))

        def H(ops, ovs):
            s1, b1 = builder._contract(ops, ovs, [])
            s2 = None
            for i in range(len(ops)):
                ops_i = list(ops)
                ops_i[i] = _xlogx(ops[i])
                t, _ = builder._contract(ops_i, ovs, [])
                s2 = t if s2 is None else s2 + t
            pos = s1 > 0
            h = torch.where(
                pos,
                torch.log(s1.clamp_min(_PROG_TINY)) - s2 / torch.where(pos, s1, 1.0),
                0.0,
            )
            return h if b1 else h.reshape(()).expand(B)

        ent = None
        for c in range(tree.num_cliques):
            h = H(*builder._node_ops(c, st, pots, masks))
            ent = h if ent is None else ent + h
        for c in range(tree.num_cliques):
            if c == tree.root:
                continue
            ent = ent - H(
                [st[("up", c)], st[("down", c)]],
                [builder._upv(c), builder._downv(c)],
            )
        logz = st[("z",)]
        fin = torch.isfinite(logz)
        return torch.where(fin, ent, 0.0), torch.where(fin, torch.exp(logz), 0.0)

    return fn


def batched_propagate_program(
    plan: Plan,
    semiring: Semiring = SUM_PRODUCT,
    observed: Optional[Sequence[int]] = None,
    rescale: bool = False,
    tp=None,
):
    """Build ``fn(pots, masks) -> (var_marginals [B,size_v] list, Z [B])``.

    ``pots`` are unbatched clique potentials (semiring space); ``masks`` is
    a list aligned with ``observed`` (var ids), each [B, size_v] in semiring
    space.  Only observed variables carry masks — unobserved ones are
    implicitly all-ones, which keeps evidence-free parts of the tree
    unbatched.  ``observed=None`` means every variable is masked.

    ``rescale=True`` (linear sum-product only): every message is divided by
    its max and the collect offsets accumulate, so the returned Z is
    ``logZ`` [B] and the marginals are unnormalized but bounded — normalize
    per variable (this is what ``Engine.posterior_batch`` does).  ``tp``:
    see :func:`_try_big_clique_route`."""
    return BatchedProgramBuilder(
        plan, semiring, observed, rescale=rescale, tp=tp,
        headroom=True).full()


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA device 0, and
    raises where there is none (no quiet fall to the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "junctiontree_tpu_torch runs on CUDA device 0 by default, and "
            "torch.cuda.is_available() is false; pass device=\"cpu\" to run "
            "on the CPU"
        )
    return torch.device("cuda", 0)


def _normalize(semiring: Semiring, margs: Sequence[torch.Tensor]):
    """Per-variable posteriors (linear space) from semiring-space
    marginals.  A row of impossible evidence (all semiring zeros) comes out
    as zeros: in log space its normalizer is -inf and is replaced by 0."""
    with TIMERS.span("program.normalize"):
        if semiring == SUM_PRODUCT:
            return [m / m.sum(dim=-1, keepdim=True).clamp_min(_PROG_TINY)
                    for m in margs]
        out = []
        for m in margs:
            if semiring == MAX_PRODUCT:
                norm = m.amax(dim=-1, keepdim=True)
            else:
                norm = torch.logsumexp(m, dim=-1, keepdim=True)
            norm = torch.where(torch.isneginf(norm), torch.zeros_like(norm),
                               norm)
            out.append(torch.exp(m - norm))
        return out


class Engine:
    """Inference engine for one compiled Plan on one torch device.

    ``set_potentials`` precomputes clique potentials once; ``query``,
    ``query_batch`` and ``posterior_batch`` then serve evidence against
    them, and so do the other query surfaces: ``map_assignment(_batch)`` and
    ``top_k_assignments(_batch)`` (exact MAP and k-best), ``entropy(_batch)``,
    ``joint_marginal(_batch)`` and ``mutual_information``, and
    ``incremental`` (a cached-collect session).  ``multiply_factor`` edits
    the standing potentials of a live engine; ``save`` / ``load`` checkpoint
    it.  ``semiring`` is ``SUM_PRODUCT``, ``LOG_SUM_EXP`` or
    ``MAX_PRODUCT``.  ``device`` places the potentials, masks and messages
    (default CUDA device 0; pass ``device="cpu"`` to run on the CPU).

    ``dtype`` (default ``config.DEFAULT.storage_dtype``) is
    ``torch.float32``, ``torch.float64`` or ``torch.bfloat16``.  bfloat16 is
    a storage dtype for the rescaled sum-product serving program only: its
    potentials and messages sit in bfloat16 while contractions accumulate
    in float32 and posteriors and logZ come out float32;
    ``propagate``, ``query``, ``query_batch``, the chain and level-fused
    programs, and engines on a log semiring compute in float32."""

    def __init__(
        self,
        plan: Plan,
        semiring: Semiring = SUM_PRODUCT,
        *,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        if semiring not in SEMIRINGS.values():
            raise ValueError(f"unknown semiring {semiring!r}")
        if dtype is None:
            dtype = getattr(torch, _CFG.storage_dtype)
        if dtype not in (torch.float32, torch.float64, torch.bfloat16):
            raise ValueError(
                f"dtype {dtype} is not supported: use torch.float32, "
                "torch.float64 or torch.bfloat16"
            )
        self.plan = plan
        self.semiring = semiring
        self.device = resolve_device(device)
        self.dtype = dtype
        # what the parity paths compute in, and every path returns
        self.compute_dtype = (
            torch.float32 if dtype is torch.bfloat16 else dtype
        )
        self._pots: Optional[List[torch.Tensor]] = None
        self._pots_np: Optional[List[np.ndarray]] = None
        self._pots_prog: Optional[List[torch.Tensor]] = None
        self._programs: Dict[tuple, object] = {}
        self._chain: Optional[tuple] = None   # lazy ChainLayout cache
        self._chain_A: Optional[torch.Tensor] = None   # stacked transitions
        self._hmm: Optional[tuple] = None     # lazy HMMLayout cache
        self._hmm_stacks = None               # stacked HMM potentials
        self._fused_sched = None              # lazy fused schedule
        self._fused_stack = None              # stacked fused group potentials
        self._max_engine: Optional["Engine"] = None   # cached MAP sibling
        self._mask_sharding = None            # set by shard_batch()
        self._replicas: Dict[str, "Engine"] = {}     # per device of it
        self._model_mesh = None               # set by shard_model()
        self._tp_min_states = _CFG.tp_min_states
        self._tp_shard_batch = False
        self._tp_notes: List[str] = []        # gathered-contraction notes
        self._seq_mesh = None                 # set by shard_sequence()
        self._seq_axis = "batch"
        self._seq_min_len = 2048
        self._kept_reckoned = None  # (threshold, bytes): _kept_bytes_bound

    def _place(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.compute_dtype, device=self.device)

    def _place_mask(self, x) -> torch.Tensor:
        """An evidence mask on the engine's device; what comes from the host
        to another device counts in ``serve.mask_bytes``."""
        t = self._place(x)
        if self.device.type != "cpu" and (
                not isinstance(x, torch.Tensor) or x.device.type == "cpu"):
            TIMERS.add("serve.mask_bytes", t.numel() * t.element_size())
        return t

    def storage_dtype(self) -> torch.dtype:
        """Dtype of the general serving program's potentials and messages:
        bfloat16 only for a sum-product engine asked for it
        (logsumexp in bfloat16 loses the tail), else the compute dtype."""
        if self.dtype is torch.bfloat16 and self.semiring == SUM_PRODUCT:
            return torch.bfloat16
        return self.compute_dtype

    def _chain_layout(self):
        if self._chain is None:
            from .scan_executor import ChainLayout

            self._chain = (ChainLayout.detect(self.plan),)
        return self._chain[0]

    def _hmm_layout(self):
        """The plan as a hidden Markov model (``scan_executor.HMMLayout``),
        or None; a uniform chain is not one here (its program is the
        chain's)."""
        if self._hmm is None:
            from .scan_executor import HMMLayout

            self._hmm = (None if self._chain_layout() is not None
                         else HMMLayout.detect(self.plan),)
        return self._hmm[0]

    # -- reference-parity path: values in, unnormalized factor marginals out --
    def propagate(self, values: Sequence[np.ndarray]) -> List[np.ndarray]:
        sr = self.semiring
        vals = [sr.from_linear(self._place(v)) for v in values]
        pots = evaluate_cliques(self.plan, vals, sr,
                                max_states=self._feasible_cap())
        beliefs, _ = propagate_cliques(self.plan, pots, sr)
        return [
            sr.to_linear(x).cpu().numpy()
            for x in factor_marginals(self.plan, beliefs, sr)
        ]

    # -- serving: precompute potentials once, then mask-only queries --
    def set_potentials(
        self, values: Sequence[np.ndarray], dtype=np.float64
    ) -> "Engine":
        """Evaluate the clique potentials from the factor values (linear
        space) on the host in ``dtype`` (default float64) and install them
        on the device in the engine's dtype."""
        vals = [np.asarray(v, dtype=np.float64) for v in values]
        if self.semiring.is_log:
            with np.errstate(divide="ignore"):
                vals = [np.log(v) for v in vals]
        with TIMERS.phase("engine.evaluate"):
            pots = evaluate_cliques_np(self.plan, vals, self.semiring,
                                       dtype=dtype,
                                       max_states=self._feasible_cap())
        return self.set_clique_potentials(pots)

    def set_clique_potentials(self, pots: Sequence[np.ndarray]) -> "Engine":
        """Install evaluated clique potentials (one array per clique, in
        ``plan.clique_vars`` axis order, in the semiring's space) without
        re-evaluating factors."""
        if len(pots) != self.plan.tri.num_cliques:
            raise ValueError(
                "expected %d clique potentials, got %d"
                % (self.plan.tri.num_cliques, len(pots))
            )
        for c, p in enumerate(pots):
            if tuple(np.shape(p)) != self.plan.clique_shape(c):
                raise ValueError(
                    "clique %d potential has shape %r, expected %r"
                    % (c, tuple(np.shape(p)), self.plan.clique_shape(c))
                )
        self._pots_np = [np.asarray(p) for p in pots]
        with TIMERS.phase("engine.upload"):
            self._pots = self._place_pots(self._pots_np)
        # everything derived from the potentials is rebuilt at next use
        self._pots_prog = None
        self._chain_A = None
        self._hmm_stacks = None
        self._fused_stack = None
        self._max_engine = None
        self._replicas = {}
        return self

    def _place_pots(self, pots: Sequence[np.ndarray]) -> list:
        """Install the potentials on the device; on a ``shard_model`` engine
        every clique of at least ``tp_min_states`` states is split flat over
        the mesh's model axis (a :class:`parallel.tp.ShardedPotential`).  A
        clique whose states do not divide over the axis is refused above the
        single-device cap, and placed whole (with a note) below it."""
        if self._model_mesh is None:
            out = [self._place(p) for p in pots]
            self._mark_standing(out)
            return out
        n = int(self._model_mesh.shape[MODEL_AXIS])
        rows = self._model_mesh.devices.shape[0] if self._tp_shard_batch else 1
        out = []
        for c, p in enumerate(pots):
            if p.size >= self._tp_min_states:
                if p.size % n == 0:
                    out.append(ShardedPotential(
                        p, self._model_mesh, self.compute_dtype,
                        self.compute_dtype, self.device, n_rows=rows))
                    continue
                if p.size > MAX_CLIQUE_STATES:
                    raise ValueError(
                        f"clique {c} has {p.size:,} states: above the "
                        f"single-device cap and not divisible by the model "
                        f"axis size {n}; use a model-axis size that divides "
                        "the clique state space"
                    )
                self._tp_notes.append(
                    f"clique {c} ({p.size:,} states) not divisible by model "
                    f"axis {n}; placed unsharded on one device"
                )
            out.append(self._place(p))
        self._mark_standing(out)
        return out

    def _require_pots(self, whole: bool = True) -> list:
        """The potentials on the device, each whole (a sharded one gathered
        onto the engine's device), or with ``whole=False`` as they are
        stored (what the general program, which routes sharded cliques
        through the sharded contraction, reads)."""
        if self._pots is None:
            raise RuntimeError("call set_potentials(values) before querying")
        if whole and self._model_mesh is not None:
            return [p.gather() if isinstance(p, ShardedPotential) else p
                    for p in self._pots]
        return self._pots

    def _program_pots(self) -> list:
        """Potentials as the general serving program reads them: cast to
        the storage dtype once per ``set_potentials``."""
        pots = self._require_pots(whole=False)
        storage = self.storage_dtype()
        if storage == self.compute_dtype:
            return pots
        if self._pots_prog is None:
            self._pots_prog = [p.to(storage) for p in pots]
            self._mark_standing(self._pots_prog)
        return self._pots_prog

    def _require_pots_np(self) -> List[np.ndarray]:
        if self._pots_np is None:
            raise RuntimeError("call set_potentials(values) before querying")
        return self._pots_np

    def multiply_factor(self, scope, value) -> "Engine":
        """Bake a new factor into the standing potentials of a LIVE engine
        (the serving-side face of a covered ``surgery.add_factor``):
        ``scope`` must be covered by an existing clique, so every potential
        keeps its shape and every cached program stays valid -- only the
        clique's numbers change.

        ``value`` is a linear-space array shaped like ``scope`` (converted
        to the engine's semiring space internally).  The factor is
        multiplied into the smallest containing clique's potential;
        subsequent queries see the updated model immediately.  Everything
        derived from the potentials (the chain and fused stacks, the
        max-product sibling, the program's storage copy) is rebuilt at next
        use.  Note this edits the *potentials*, not the factor list:
        ``propagate(values)`` still expects the original factors (use
        ``surgery.add_factor`` and a new Engine for that path).  Raises
        ValueError for uncovered scopes."""
        plan = self.plan
        pots = list(self._require_pots_np())
        labels = list(scope)
        unknown = [v for v in labels if v not in plan.table]
        if unknown:
            raise ValueError(
                "multiply_factor scope has unknown variables %r" % (unknown,)
            )
        ids = [plan.table.id_of(v) for v in labels]
        idset = set(ids)
        val = np.asarray(value, dtype=np.float64)
        if val.shape != tuple(plan.sizes[v] for v in ids):
            raise ValueError(
                "value shape %r does not match scope %r sizes %r"
                % (val.shape, labels, tuple(plan.sizes[v] for v in ids))
            )
        ci, ci_states = -1, None
        for c, cv in enumerate(plan.tri.maxcliques):
            if idset <= set(cv):
                states = _vars_states(plan.sizes, cv)
                if ci_states is None or states < ci_states:
                    ci, ci_states = c, states
        if ci < 0:  # empty scopes always match (smallest clique)
            raise ValueError(
                "scope %r is not covered by any clique; rebuild via "
                "surgery.add_factor instead" % (labels,)
            )
        cv = plan.tri.maxcliques[ci]
        # broadcast value into the clique's axis order
        order = sorted(range(len(ids)), key=lambda i: cv.index(ids[i]))
        val_b = np.transpose(val, order).reshape(
            tuple(plan.sizes[v] if v in idset else 1 for v in cv)
        )
        if self.semiring.is_log:
            with np.errstate(divide="ignore"):
                pots[ci] = pots[ci] + np.log(val_b)
        else:
            pots[ci] = pots[ci] * val_b
        return self.set_clique_potentials(pots)

    # -- checkpoint and resume of the full serving state --
    def save(self, path: str) -> None:
        """Write plan + evaluated clique potentials + semiring to one .npz
        (``__plan__``, ``__semiring__``, ``pot_i``: the JAX package's
        ``Engine.save`` layout, so either package loads the other's file).
        The potentials saved are the host arrays in the semiring's space as
        ``set_potentials`` evaluated them, also on a bfloat16 engine."""
        if self._pots_np is None:
            raise RuntimeError("call set_potentials(values) before save()")
        arrs = {f"pot_{i}": p for i, p in enumerate(self._pots_np)}
        np.savez_compressed(
            path,
            __plan__=np.frombuffer(
                self.plan.to_json().encode("utf-8"), dtype=np.uint8
            ),
            __semiring__=np.array(self.semiring.name),
            **arrs,
        )

    @classmethod
    def load(
        cls, path: str, device=None, dtype: Optional[torch.dtype] = None
    ) -> "Engine":
        """Restore an engine checkpointed with ``save`` (plan, potentials,
        semiring) on ``device`` (default CUDA device 0): ready to query
        immediately, without re-triangulating or re-evaluating.  ``dtype``
        is ``Engine``'s (the file holds the host potentials, not a dtype)."""
        from .schedule import plan_from_json

        device = resolve_device(device)
        with np.load(path, allow_pickle=False) as d:
            plan = plan_from_json(bytes(d["__plan__"].tobytes()).decode("utf-8"))
            semiring = SEMIRINGS[str(d["__semiring__"])]
            pots = [
                np.asarray(d[f"pot_{i}"]) for i in range(plan.tri.num_cliques)
            ]
        return cls(
            plan, semiring, device=device, dtype=dtype
        ).set_clique_potentials(pots)

    def describe(self) -> dict:
        """Introspection: plan stats, which execution tiers are engaged,
        the big-clique kernel's launch counters and, under ``counters``,
        every counter of the port by name (``utils.timing.TIMERS``;
        process-wide, like the phase timers)."""
        counters = TIMERS.counters()
        st = self.plan.stats()
        st["semiring"] = self.semiring.name
        st["device"] = str(self.device)
        st["dtype"] = str(self.dtype).split(".")[-1]
        st["potentials_set"] = self._pots is not None
        st["chain_layout"] = self._chain_layout() is not None
        st["hmm_layout"] = self._hmm_layout() is not None
        st["cached_programs"] = sorted(str(k[0]) for k in self._programs)
        st["process_phase_totals_s"] = TIMERS.report()
        k1 = "factored_masked_contract"
        st["kernel_launches"] = {
            k1: counters[k1 + ".launches"],
            k1 + "_bf16": counters[k1 + ".launches_bf16"],
            k1 + "_backward": counters[k1 + ".launches_backward"],
            "big_clique_route_calls": counters["big_clique_sep_message.calls"],
        }
        from .ops.autotune import report

        rt = report()
        if rt:
            st["kernel_routing"] = rt
        if self._model_mesh is not None:
            st["tp_fallbacks"] = list(self._tp_notes)
        st["kept_layouts"] = self._kept_now()
        st["counters"] = counters
        return st

    def _standing(self) -> list:
        """The engine's standing potential tensors: as set, and the serving
        program's storage copies (bfloat16 storage)."""
        pots = [p for p in (self._pots or []) if isinstance(p, torch.Tensor)]
        return pots + [p for p in (self._pots_prog or [])
                       if isinstance(p, torch.Tensor)
                       and not any(p is q for q in pots)]

    def _kept_now(self) -> dict:
        """What the card keeps beside the standing potentials now
        (``ops.factored_contract.kept``): layouts and their bytes."""
        from .ops.factored_contract import kept_sizes

        sizes = [b for p in self._standing() for b in kept_sizes(p)]
        return {"layouts": len(sizes), "bytes": sum(sizes)}

    def _kept_layouts(self, c: int) -> int:
        """How many contractions one call routes to clique ``c``'s
        potential, each in a layout of its own: one for each of its
        variables' marginals, each of its neighbours' messages, and Z.
        What the card keeps beside the potential is bounded by that."""
        tree = self.plan.tree
        return (len(self.plan.clique_vars[c]) + len(tree.children[c])
                + int(tree.parent[c] >= 0) + 1)

    def _mark_standing(self, pots) -> None:
        """Mark the potentials the engine keeps as standing
        (``ops.factored_contract.standing``): on the card the route keeps
        what the kernel reads of them."""
        from .ops.factored_contract import standing

        for c, p in enumerate(pots):
            if isinstance(p, torch.Tensor):
                standing(p, self._kept_layouts(c))

    def _kept_bytes_bound(self) -> int:
        """The most the card keeps beside this engine's potentials: for
        each clique whose potential the route hands the kernel, and each
        dtype the engine stores it in (the serving program reads the
        bfloat16 storage copies, entropy and joints the float32 potentials
        as set), ``_kept_layouts`` times its largest layout
        (``ops.factored_contract.layout_bytes_bound``, in closed form over
        every grouping of its axes: 6.06 B a state in float32, 16 B in
        bfloat16, whose rows of one column are padded to eight); 0 on the
        CPU, where nothing is kept.

        Which cliques: those whose potential one ``posterior_batch`` on
        meta tensors (nothing computed, no device) with evidence on every
        variable hands the kernel (``factored_contract.handed``), reckoned
        once per engine and threshold.  The route hands a potential over
        only where every message of the contraction is batched (a message
        from a subtree without evidence is multiplied in first, a product
        that keeps nothing), and evidence everywhere batches them all, so
        no other pattern hands over a clique this one does not."""
        from .ops.factored_contract import handed, layout_bytes_bound

        if self.device.type == "cpu" or self.semiring != SUM_PRODUCT:
            return 0
        key = _CFG.big_clique_min_states
        if self._kept_reckoned is None or self._kept_reckoned[0] != key:
            meta = Engine(self.plan, self.semiring, device="meta",
                          dtype=self.dtype)
            meta._pots = [torch.empty(self.plan.clique_shape(c),
                                      dtype=self.compute_dtype, device="meta")
                          for c in range(self.plan.tri.num_cliques)]
            meta._mark_standing(meta._pots)
            meta.posterior_batch([torch.empty((1, k), device="meta")
                                  for k in self.plan.sizes])
            progs = meta._pots_prog or meta._pots
            dtypes = {self.compute_dtype, self.storage_dtype()}
            total = sum(
                self._kept_layouts(c) * layout_bytes_bound(p.shape, dt)
                for c, (p, q) in enumerate(zip(meta._pots, progs))
                if handed(p) or handed(q) for dt in dtypes)
            self._kept_reckoned = (key, total)
        return self._kept_reckoned[1]

    def __repr__(self) -> str:
        st = self.plan.stats()
        return (
            f"Engine({self.semiring.name}, vars={st['num_vars']}, "
            f"cliques={st['num_cliques']}, treewidth={st['treewidth']}, "
            f"max_states={st['max_clique_states']}, device={self.device}, "
            f"dtype={self.dtype})"
        )

    def query(
        self,
        evidence: Optional[Dict[Hashable, int]] = None,
        normalize: bool = True,
    ) -> Tuple[List[np.ndarray], float]:
        """Posterior per-variable marginals under evidence + normalization
        constant P(evidence) (unnormalized marginals if normalize=False)."""
        pots = self._require_pots()
        sr = self.semiring
        masks = evidence_to_masks(self.plan, evidence or {}, sr)
        mpots = apply_masks(self.plan, pots, [self._place(m) for m in masks], sr)
        beliefs, _ = propagate_cliques(self.plan, mpots, sr)
        margs = var_marginals(self.plan, beliefs, sr)
        zlin = float(sr.to_linear(partition(self.plan, beliefs, sr)))
        if normalize and sr.is_log:
            # normalize in log space (stable even when linear Z overflows)
            out = []
            for m in margs:
                m = m.double().cpu().numpy()
                mx = m.max()
                if not np.isfinite(mx):
                    out.append(np.exp(m))
                    continue
                e = np.exp(m - mx)
                out.append(e / e.sum())
            return out, zlin
        margs = [sr.to_linear(m).cpu().numpy() for m in margs]
        if normalize:
            margs = [m / m.sum() if m.sum() != 0 else m for m in margs]
        return margs, zlin

    def _masks_to_program_args(self, mask_batch):
        with TIMERS.span("serve.masks"):
            if isinstance(mask_batch, dict):
                ids = sorted(self.plan.table.id_of(k) for k in mask_batch)
                by_id = {self.plan.table.id_of(k): v
                         for k, v in mask_batch.items()}
                masks = [self._place_mask(by_id[v]) for v in ids]
            else:
                ids = list(range(self.plan.num_vars))
                masks = [self._place_mask(m) for m in mask_batch]
            batch_sizes = {int(m.shape[0]) for m in masks}
            if len(batch_sizes) > 1:
                raise ValueError(
                    "inconsistent batch sizes across evidence masks: %s"
                    % sorted(batch_sizes)
                )
            for v, m in zip(ids, masks):
                if m.dim() != 2 or m.shape[1] != self.plan.sizes[v]:
                    raise ValueError(
                        "mask for variable %r must be [B, %d], got %r"
                        % (
                            self.plan.table.label_of(v),
                            self.plan.sizes[v],
                            tuple(m.shape),
                        )
                    )
            return tuple(ids), masks

    def _general_program(self, ids: tuple, rescale: bool):
        key = ("general", rescale, ids, _CFG.distribute_division)
        fn = self._programs.get(key)
        if fn is None:
            with TIMERS.phase("program.build"):
                fn = batched_propagate_program(
                    self.plan, self.semiring, list(ids), rescale=rescale,
                    tp=self._tp(),
                )
            self._programs[key] = fn
        return fn

    def query_batch(self, mask_batch):
        """Batched evidence queries on the parity path: returns
        (unnormalized var marginals [B, size_v] over ALL var ids, Z [B]),
        both in the semiring's space and the compute dtype.

        ``mask_batch`` is a dict {var label: [B, size_v] masks} for the
        observed variables (evidence-free parts of the tree then run
        unbatched), or a full per-var-id list of [B, size_v] arrays; masks
        are in the semiring's space.  Runs the batch-aware program without
        rescaling, on unbatched potentials."""
        if self._mask_sharding is not None:
            return self._rows_sharded("query_batch", mask_batch)
        pots = self._require_pots(whole=False)
        ids, masks = self._masks_to_program_args(mask_batch)
        return self._general_program(ids, False)(pots, masks)

    def query_batch_vmap(self, mask_batch: Sequence):
        """``torch.vmap`` of the parity path over the batch (every operand
        batched; one [B, size_v] mask per variable id, in the semiring's
        space): (unnormalized var marginals [B, size_v], Z [B]) in the
        semiring's space.  Kept beside ``query_batch`` for differential
        testing."""
        pots = self._require_pots()
        plan, sr = self.plan, self.semiring
        masks = [self._place(m) for m in mask_batch]

        def one(ms):
            beliefs, _ = propagate_cliques(
                plan, apply_masks(plan, pots, list(ms), sr), sr)
            return var_marginals(plan, beliefs, sr), partition(plan, beliefs, sr)

        return torch.vmap(one)(masks)

    def _fused_schedule(self):
        if self._fused_sched is None:
            from .fused import build_fused_schedule

            self._fused_sched = build_fused_schedule(self.plan)
        return self._fused_sched

    def _route(self, mode: str) -> str:
        """Which serving program ``posterior_batch`` runs: "chain", "hmm",
        "fused" or "general".  Auto mode on a sum-product engine takes the
        chain program on a uniform chain, the HMM program on a hidden Markov
        model (``scan_executor.HMMLayout``: a uniform chain whose variables
        carry leaves), and the level-fused program on a model of at least
        32 cliques, none above 2^13 states, whose level grouping at least
        halves the number of per-clique steps."""
        if mode == "fused":
            return "fused"
        if mode == "general" or self.semiring != SUM_PRODUCT:
            return "general"
        if self._chain_layout() is not None:
            return "chain"
        if self._hmm_layout() is not None:
            return "hmm"
        st = self.plan.stats()
        if st["num_cliques"] >= 32 and st["max_clique_states"] <= (1 << 13):
            sched = self._fused_schedule()[0]
            n_groups = sum(len(gs) for gs in sched.levels)
            if n_groups * 2 <= st["num_cliques"]:
                return "fused"
        return "general"

    def _posterior_general(self, ids, masks):
        sr = self.semiring
        prog = self._general_program(ids, sr == SUM_PRODUCT)
        margs, logz = prog(self._program_pots(), masks)
        return _normalize(sr, margs), logz

    def _posterior_chain(self, ids, masks):
        """The chain program; on a ``shard_sequence`` engine and a chain of
        at least ``min_len`` cliques the log-depth program, with the steps
        of the transitions split over the axis's devices."""
        from .scan_executor import (
            StackedPosteriors,
            chain_posterior_parallel_program,
            chain_posterior_program,
            stack_chain_potentials,
        )

        layout = self._chain_layout()
        parallel = (self._seq_mesh is not None
                    and len(layout.clique_order) >= self._seq_min_len)
        key = ("chain_parallel",) if parallel else ("chain",)
        prog = self._programs.get(key)
        if prog is None:
            make = (chain_posterior_parallel_program if parallel
                    else chain_posterior_program)
            with TIMERS.phase("program.build"):
                prog = make(self.plan, layout)
            self._programs[key] = prog
        if self._chain_A is None:
            A = stack_chain_potentials(layout, self._pots_np)
            if parallel:
                devs = self._seq_mesh.local_devices(self._seq_axis)
                self._chain_A = [
                    torch.as_tensor(A[rows], dtype=self.compute_dtype,
                                    device=dev)
                    for rows, dev in zip(row_blocks(len(A), len(devs)), devs)
                ]
            else:
                self._chain_A = self._place(A)
        stacked, logz = prog(self._chain_A, dict(zip(ids, masks)))
        return StackedPosteriors(stacked, layout.var_order), logz

    def _posterior_hmm(self, ids, masks):
        """The HMM program: sequential passes, whatever the sequence
        sharding."""
        from .scan_executor import hmm_posterior_program, stack_hmm_potentials

        layout = self._hmm_layout()
        prog = self._programs.get(("hmm",))
        if prog is None:
            with TIMERS.phase("program.build"):
                prog = hmm_posterior_program(self.plan, layout)
            self._programs[("hmm",)] = prog
        if self._hmm_stacks is None:
            with TIMERS.phase("engine.stack"):
                self._hmm_stacks = stack_hmm_potentials(
                    layout, self._require_pots())
        return prog(self._hmm_stacks, dict(zip(ids, masks)))

    def _posterior_fused(self, ids, masks):
        from .fused import (
            FusedPosteriors,
            fused_posterior_program,
            stack_group_potentials,
        )

        if self.semiring != SUM_PRODUCT:
            raise ValueError("fused path requires the sum_product semiring")
        sched, sorted_children = self._fused_schedule()
        if self._fused_stack is None:
            self._fused_stack = [
                [self._place(p) for p in level]
                for level in stack_group_potentials(sched, self._pots_np)
            ]
        prog = self._programs.get(("fused", ids))
        if prog is None:
            with TIMERS.phase("program.build"):
                prog = fused_posterior_program(
                    sched, sorted_children, list(ids), device=self.device
                )
            self._programs[("fused", ids)] = prog
        marg, logz = prog(self._fused_stack, masks)
        return FusedPosteriors(sched, marg), logz

    def posterior_batch_fused(self, mask_batch):
        """Level-fused serving path (see ``fused.py``): same contract as
        ``posterior_batch``, in O(levels x groups) device operations instead
        of O(cliques).  Linear sum-product only."""
        return self.posterior_batch(mask_batch, mode="fused")

    def posterior_batch(
        self, mask_batch, mode: str = "auto", chunk: Optional[int] = None
    ):
        """Serving path: normalized per-variable posteriors + log-partition.

        ``mask_batch`` is a dict {var label: [B, size_v] mask} for the
        observed variables (evidence-free parts of the tree then run
        unbatched), or a list of [B, size_v] masks for every variable id;
        numpy arrays or tensors, in the semiring's space.

        A sum-product engine runs rescaled message passing: every message is
        divided by its max and the collect offsets accumulate into logZ, so
        the result is stable where plain linear space would over- or
        underflow.  Log-space engines run unrescaled and normalize with
        logsumexp (max-product: by the max).

        ``mode``: "auto" takes the chain program on a uniform chain, its
        HMM program on a hidden Markov model (a uniform chain whose
        variables carry leaves: the leaves' evidence folded into the hidden
        masks, the chain's two passes, the leaves' posteriors from the
        hidden ones), the level-fused program on regular models of many
        small cliques, else the general batch-aware program (see
        ``_route``); "general" and "fused" force a program.

        ``chunk``: serve a batch of more than ``chunk`` rows in row slices
        of that many, through the general program, writing into
        preallocated [B, size_v] outputs, so that the step's peak memory is
        that of ``chunk`` rows.  Rows are independent, so the result is that
        of the unchunked call; the last slice is simply shorter.  With
        ``B <= chunk`` the call is the unchunked one in the caller's
        ``mode``.

        Returns (posteriors: indexable by var id, each [B, size_v]; logZ:
        [B]) on the engine's device in its compute dtype.  Impossible
        evidence gives zero posteriors and logZ = -inf."""
        with TIMERS.call("serve.posterior_batch"):
            if mode not in ("auto", "general", "fused"):
                raise ValueError(f"unknown mode {mode!r}")
            if chunk is not None:
                chunk = int(chunk)
                if chunk < 1:
                    raise ValueError("chunk must be >= 1")
            if self._mask_sharding is not None:
                return self._rows_sharded("posterior_batch", mask_batch,
                                          mode=mode, chunk=chunk)
            self._require_pots(whole=False)
            ids, masks = self._masks_to_program_args(mask_batch)
            B = int(masks[0].shape[0]) if masks else 1
            if chunk is None or B <= chunk:
                run = getattr(self, "_posterior_" + self._route(mode))
                return run(ids, masks)
            posts = [
                torch.empty((B, s), dtype=self.compute_dtype,
                            device=self.device)
                for s in self.plan.sizes
            ]
            logz = torch.empty((B,), dtype=self.compute_dtype,
                               device=self.device)
            for lo in range(0, B, chunk):
                rows = slice(lo, min(lo + chunk, B))
                post_c, logz_c = self._posterior_general(
                    ids, [m[rows] for m in masks]
                )
                for out, p in zip(posts, post_c):
                    out[rows] = p
                logz[rows] = logz_c
            return posts, logz

    # -- entropy, joint marginals, mutual information --
    def _require_probability_semiring(self, what: str) -> None:
        if self.semiring not in (SUM_PRODUCT, LOG_SUM_EXP):
            raise ValueError(
                "%s needs a probability semiring "
                "(sum_product or log_sum_exp), not %r"
                % (what, self.semiring.name)
            )

    def _calibrate(self, pots, masks):
        """Per-element form: masks applied to the potentials, two-pass
        propagation; (clique beliefs, separator beliefs, Z) in the
        semiring's space."""
        sr = self.semiring
        mpots = apply_masks(self.plan, pots, masks, sr)
        cb, sb = propagate_cliques(self.plan, mpots, sr)
        return cb, sb, partition(self.plan, cb, sr)

    def _entropy_element(self, pots, masks):
        """(H, Z in the semiring's space) of one evidence row from the
        calibrated beliefs: H(P) = sum_C H(b_C) - sum_S H(b_S)."""
        sr = self.semiring
        cb, sb, z = self._calibrate(pots, masks)

        def H(b):
            flat = b.reshape(-1)
            if sr.is_log:
                lp = flat - torch.logsumexp(flat, dim=0)
                p = torch.exp(lp)
            else:
                p = flat / flat.sum().clamp_min(_PROG_TINY)
                lp = torch.log(p.clamp_min(_PROG_TINY))
            return -torch.where(p > 0, p * lp, 0.0).sum()

        ent = H(cb[0])
        for b in cb[1:]:
            ent = ent + H(b)
        for b in sb:
            ent = ent - H(b)
        return ent, z

    def entropy(
        self, evidence: Optional[Dict[Hashable, int]] = None
    ) -> Tuple[float, float]:
        """Exact Shannon entropy (nats) of the posterior joint distribution
        given the evidence, plus P(evidence).

        Calibrated-tree identity: P(x) = prod_C b_C(x_C) / prod_S b_S(x_S),
        so H(P) = sum_C H(b_C) - sum_S H(b_S) with normalized clique /
        separator beliefs -- O(total clique states), never enumerating the
        joint."""
        self._require_probability_semiring("entropy")
        pots = self._require_pots()
        masks = evidence_to_masks(self.plan, evidence or {}, self.semiring)
        ent, z = self._entropy_element(pots, [self._place(m) for m in masks])
        return float(ent), float(self.semiring.to_linear(z))

    def entropy_batch(self, mask_batch):
        """Batched posterior joint entropies under an evidence-mask batch.

        ``mask_batch``: dict {var label: [B, size_v]} masks in the engine's
        semiring space (unobserved vars default to all-ones), or a full
        per-var-id list.  Returns (entropies [B], Z [B]) tensors on the
        engine's device in its compute dtype (float32 on a bfloat16
        engine); Z is linear-space P(evidence) regardless of semiring.
        Impossible evidence gives H = 0 and Z = 0.

        A sum-product engine runs the batch-aware routed program
        (``batched_entropy_program``) over only the observed variables; a
        log-sum-exp engine runs the per-element form row by row under
        ``torch.vmap`` (the operand-log decomposition needs linear
        operands).  That form holds every clique's belief for every row at
        once, several times B x (total clique states) elements: choose B
        from the plan's ``total_clique_states`` and the device's memory."""
        self._require_probability_semiring("entropy")
        if self._mask_sharding is not None:
            return self._rows_sharded("entropy_batch", mask_batch)
        pots = self._require_pots()
        ids, masks = self._masks_to_program_args(mask_batch)
        if self.semiring == SUM_PRODUCT:
            key = ("entropy_batch", ids)
            fn = self._programs.get(key)
            if fn is None:
                fn = batched_entropy_program(self.plan, list(ids))
                self._programs[key] = fn
            return fn(pots, masks)
        B = int(masks[0].shape[0]) if masks else 1
        by_id = dict(zip(ids, masks))
        full = [
            by_id[v] if v in by_id else torch.full(
                (B, self.plan.sizes[v]), self.semiring.one,
                dtype=self.compute_dtype, device=self.device,
            )
            for v in range(self.plan.num_vars)
        ]
        ent, z = torch.vmap(
            lambda ms: self._entropy_element(pots, ms)
        )(full)
        return ent, self.semiring.to_linear(z)

    def _joint_query_ids(self, variables) -> List[int]:
        self._require_probability_semiring("joint_marginal")
        variables = list(variables)
        if len(set(variables)) != len(variables):
            raise ValueError("variables contains duplicates")
        return [self.plan.table.id_of(v) for v in variables]

    def joint_marginal(
        self,
        variables: Sequence[Hashable],
        evidence: Optional[Dict[Hashable, int]] = None,
        normalize: bool = True,
        max_states: int = 1 << 24,
    ):
        """Exact joint marginal over an ARBITRARY variable set (the
        variables need not share a clique or even a connected component).

        Returns (table, P(evidence)): ``table`` is a linear-space float64
        numpy array with one axis per entry of ``variables`` (in that
        order), normalized to sum to 1 when ``normalize`` (the conditional
        joint P(variables | evidence)).

        Out-of-clique queries eliminate along the minimal subtree of
        calibrated cliques spanning the variables (``joint.py``).
        Intermediates are capped at ``max_states`` states (ValueError
        beyond: query fewer/closer variables or raise the cap)."""
        from .joint import joint_marginal_program

        qids = self._joint_query_ids(variables)
        pots = self._require_pots()
        sr = self.semiring
        key = ("joint", tuple(qids), int(max_states))
        prog = self._programs.get(key)
        if prog is None:
            prog = joint_marginal_program(
                self.plan, sr, qids, max_states=max_states
            )
            self._programs[key] = prog
        masks = evidence_to_masks(self.plan, evidence or {}, sr)
        cb, sb, z = self._calibrate(pots, [self._place(m) for m in masks])
        joint = prog(cb, sb).double().cpu().numpy()
        zlin = float(sr.to_linear(z))
        if sr.is_log:
            m = joint.max()
            if not np.isfinite(m):  # impossible evidence: all -inf
                return np.zeros_like(joint), zlin
            t = np.exp(joint - m)  # stabilized: max entry is exactly 1
            if normalize:
                # the exp(m) factor cancels in the ratio, so never form it:
                # it under- or overflows exactly when stabilization matters
                return t / t.sum(), zlin
            joint = t * np.exp(m)
        elif normalize:
            tot = joint.sum()
            joint = joint / tot if tot > 0 else joint
        return joint, zlin

    def joint_marginal_batch(
        self, variables: Sequence[Hashable], mask_batch,
        max_states: int = 1 << 24,
    ):
        """Batched exact joint marginals over an arbitrary variable set.

        ``mask_batch``: dict {var label: [B, size_v]} masks in the engine's
        semiring space (unobserved vars default to all-ones), or a full
        per-var-id list.  Returns (tables [B, *sizes(variables)] linear
        NORMALIZED, Z [B] linear) tensors on the engine's device in its
        compute dtype: the per-element conditional joints
        P(variables | evidence_b).

        Runs the batch-aware routed message program once and eliminates the
        Steiner subtree with batch-labelled routed contractions
        (``joint.batched_joint_marginal_program``): no per-element clique
        beliefs materialize.  Impossible evidence yields an all-zero table
        and Z = 0 for that element."""
        from .joint import batched_joint_marginal_program

        qids = self._joint_query_ids(variables)
        if self._mask_sharding is not None:
            return self._rows_sharded("joint_marginal_batch", mask_batch,
                                      variables=variables,
                                      max_states=max_states)
        pots = self._require_pots()
        ids, masks = self._masks_to_program_args(mask_batch)
        key = ("joint_batch", tuple(qids), ids, int(max_states))
        fn = self._programs.get(key)
        if fn is None:
            fn = batched_joint_marginal_program(
                self.plan, self.semiring, qids, max_states=max_states,
                observed=list(ids),
            )
            self._programs[key] = fn
        return fn(pots, masks)

    def mutual_information(
        self,
        x: Hashable,
        y: Hashable,
        evidence: Optional[Dict[Hashable, int]] = None,
    ) -> float:
        """Exact I(X;Y | evidence) in nats from the pairwise joint."""
        from .joint import mutual_information_from_joint

        joint, _ = self.joint_marginal([x, y], evidence)
        return mutual_information_from_joint(joint)

    # -- MAP and k-best decoding --
    def _max_delegate(self) -> "Engine":
        """Cached max-product sibling engine for MAP queries from non-MAP
        engines, on the same device.  Linear potentials go to log space on
        the host in float64 (floored at 1e-300, which float32 cannot hold)
        before they are cast to the compute dtype."""
        pots = self._require_pots_np()
        if self._max_engine is None:
            if not self.semiring.is_log:
                pots = [
                    np.log(np.maximum(np.asarray(p, dtype=np.float64), 1e-300))
                    for p in pots
                ]
            self._max_engine = Engine(
                self.plan, MAX_PRODUCT, device=self.device,
                dtype=self.compute_dtype,
            ).set_clique_potentials(pots)
        return self._max_engine

    def _evidence_log_masks(self, evidence) -> Dict[Hashable, np.ndarray]:
        """{label: [1, size_v] log-space mask} of one evidence dict."""
        masks = {}
        for label, state in (evidence or {}).items():
            v = self.plan.table.id_of(label)
            mk = np.full((1, self.plan.sizes[v]), -np.inf, dtype=np.float32)
            mk[0, int(state)] = 0.0
            masks[label] = mk
        return masks

    def _log_mask_args(self, mask_batch):
        """(sorted var ids, placed [B, size_v] log masks) of a label-keyed
        mask dict; with no evidence, one all-zeros row on variable 0 so
        that the programs know B."""
        with TIMERS.span("serve.masks"):
            by_id = {
                self.plan.table.id_of(k): self._place_mask(v)
                for k, v in mask_batch.items()
            }
            if not by_id:
                by_id[0] = torch.zeros(
                    (1, self.plan.sizes[0]), dtype=self.compute_dtype,
                    device=self.device,
                )
            ids = tuple(sorted(by_id))
            return ids, [by_id[v] for v in ids]

    def _chain_log_A(self) -> torch.Tensor:
        """The [m, K, K] log-transition stack of a max-product chain engine
        (its potentials are log-space already)."""
        if self._chain_A is None:
            from .scan_executor import stack_chain_potentials

            self._chain_A = self._place(
                stack_chain_potentials(self._chain_layout(), self._pots_np)
            )
        return self._chain_A

    def _map_program(self, ids: tuple):
        """``run(masks) -> (assign, score)``: the Viterbi loop on a uniform
        chain, else the tree-MAP program."""
        layout = self._chain_layout()
        if layout is not None:
            from .scan_executor import chain_viterbi_program

            prog = self._programs.get(("viterbi",))
            if prog is None:
                with TIMERS.phase("program.build"):
                    prog = chain_viterbi_program(self.plan, layout)
                self._programs[("viterbi",)] = prog
            logA = self._chain_log_A()
            return lambda masks: prog(logA, dict(zip(ids, masks)))
        from .map_executor import tree_map_program

        key = ("tree_map", ids)
        prog = self._programs.get(key)
        if prog is None:
            with TIMERS.phase("program.build"):
                prog = tree_map_program(self.plan, list(ids))
            self._programs[key] = prog
        pots = self._require_pots()
        return lambda masks: prog(pots, masks)

    def _labelled(self, row) -> Dict[Hashable, int]:
        return {
            self.plan.table.label_of(v): int(row[v])
            for v in range(self.plan.num_vars)
        }

    def map_assignment(
        self, evidence: Optional[Dict[Hashable, int]] = None
    ) -> Tuple[Dict[Hashable, int], float]:
        """MAP query: most probable joint assignment consistent with the
        evidence, via max-product message passing.

        Returns ({var label: state}, log of the unnormalized joint at the
        assignment).  Chain plans use the Viterbi loop; general trees use
        max-product with argmax backpointers + traceback
        (``map_executor.tree_map_program``), which picks a consistent joint
        argmax by construction -- ties are harmless.  A score below -1e29
        means that no assignment is consistent with the evidence."""
        if self.semiring != MAX_PRODUCT:
            return self._max_delegate().map_assignment(evidence)
        assign, score = self.map_assignment_batch(
            self._evidence_log_masks(evidence)
        )
        return self._labelled(assign[0].cpu().numpy()), float(score[0])

    def map_assignment_batch(self, mask_batch, chunk: Optional[int] = None):
        """Batched MAP queries: exact max-product with backpointer traceback
        over the whole evidence batch -- chain plans use the Viterbi loop,
        general trees the tree-MAP program
        (``map_executor.tree_map_program``).

        ``mask_batch``: dict {var label: [B, size_v]} of LOG-space masks
        (0 / -inf).  ``chunk``: serve a batch of more than ``chunk`` rows in
        row slices of that many; rows are independent, the last slice is
        simply shorter, and a chain still takes the Viterbi loop.  On the
        CPU, and for other dtypes than float32, the tree-MAP program
        materializes [B, clique_states] score tensors for the backpointer
        argmax, so there ``chunk`` bounds memory; a float32 tree-MAP on the
        card collects each clique with the fused kernel
        (``ops.map_collect``) and materializes no such tensor, so there
        ``chunk`` bounds it no more (the [B, sep_states] backpointers
        remain).  Returns (assignments [B, num_vars]
        ``torch.int32``, scores [B]) on the engine's device; a score below
        -1e29 marks a row with no feasible assignment."""
        with TIMERS.call("serve.map_assignment_batch"):
            if chunk is not None:
                chunk = int(chunk)
                if chunk < 1:
                    raise ValueError("chunk must be >= 1")
            if self._mask_sharding is not None:
                return self._rows_sharded("map_assignment_batch", mask_batch,
                                          chunk=chunk)
            if self.semiring != MAX_PRODUCT:
                return self._max_delegate().map_assignment_batch(
                    mask_batch, chunk)
            self._require_pots(whole=False)
            ids, masks = self._log_mask_args(mask_batch)
            run = self._map_program(ids)
            B = int(masks[0].shape[0])
            if chunk is None or B <= chunk:
                return run(masks)
            assign = torch.empty(
                (B, self.plan.num_vars), dtype=torch.int32, device=self.device
            )
            score = torch.empty((B,), dtype=self.compute_dtype,
                                device=self.device)
            for lo in range(0, B, chunk):
                rows = slice(lo, min(lo + chunk, B))
                assign[rows], score[rows] = run([m[rows] for m in masks])
            return assign, score

    def top_k_assignments(
        self,
        evidence: Optional[Dict[Hashable, int]] = None,
        k: int = 5,
    ) -> List[Tuple[Dict[Hashable, int], float]]:
        """The k most probable joint assignments under the evidence, best
        first (exact k-best decoding on any junction tree).

        Chain-structured plans use the list-Viterbi loop
        (``scan_executor.chain_kbest_program``); general trees use
        k-best-semiring message passing with backpointer traceback
        (``map_executor.tree_kbest_program``).

        Returns up to k ({var label: state}, log unnormalized joint) pairs:
        fewer when the model has fewer than k feasible assignments."""
        if self.semiring != MAX_PRODUCT:
            return self._max_delegate().top_k_assignments(evidence, k)
        from .scan_executor import _KBEST_PAD_FLOOR, chain_kbest_program

        self._require_pots(whole=False)
        masks = self._evidence_log_masks(evidence)
        layout = self._chain_layout()
        if layout is None:
            assign, scores = self.top_k_assignments_batch(masks, k)
        else:
            key = ("kbest", int(k))
            prog = self._programs.get(key)
            if prog is None:
                prog = chain_kbest_program(self.plan, layout, int(k))
                self._programs[key] = prog
            ids, placed = self._log_mask_args(masks)
            assign, scores = prog(self._chain_log_A(), dict(zip(ids, placed)))
        assign = assign[0].cpu().numpy()   # [K, num_vars]
        scores = scores[0].cpu().numpy()   # [K]
        out = []
        for r in range(assign.shape[0]):
            if scores[r] < _KBEST_PAD_FLOOR:
                break  # padding or an evidence-violating tail
            out.append((self._labelled(assign[r]), float(scores[r])))
        return out

    def top_k_assignments_batch(self, mask_batch, k: int = 5):
        """Batched exact k-best decoding on any junction tree.

        ``mask_batch``: dict {var label: [B, size_v]} LOG-space masks
        (0 / -inf).  Returns (assign [B, K, num_vars] ``torch.int32``,
        scores [B, K] descending) on the engine's device with
        K = min(k, total assignments): ranked DISTINCT joint assignments per
        batch element.  Evidence-violating entries (score < -1e29) appear
        only when fewer than K feasible assignments exist.

        Routes through ``map_executor.tree_kbest_program`` (k-best-semiring
        messages + traceback); works on chains too, though the unbatched
        ``top_k_assignments`` prefers the chain loop there."""
        from .map_executor import tree_kbest_program

        if self._mask_sharding is not None:
            return self._rows_sharded("top_k_assignments_batch", mask_batch,
                                      k=k)
        if self.semiring != MAX_PRODUCT:
            return self._max_delegate().top_k_assignments_batch(mask_batch, k)
        pots = self._require_pots()
        ids, masks = self._log_mask_args(mask_batch)
        key = ("tree_kbest", ids, int(k))
        fn = self._programs.get(key)
        if fn is None:
            fn = tree_kbest_program(self.plan, list(ids), int(k))
            self._programs[key] = fn
        return fn(pots, masks)

    def score_assignment(self, assignment: Dict[Hashable, int]) -> float:
        """log of the unnormalized joint value at a full assignment (on the
        host, from the potentials as ``set_potentials`` evaluated them)."""
        total = 0.0
        for c, pot in enumerate(self._require_pots_np()):
            idx = tuple(
                int(assignment[self.plan.table.label_of(v)])
                for v in self.plan.clique_vars[c]
            )
            val = float(pot[idx])
            if self.semiring.is_log:
                total += val
            else:
                if val <= 0.0:
                    return -np.inf
                total += float(np.log(val))
        return total

    # bytes one evidence row keeps alive at the peak of a call in eager
    # torch, in units of (storage itemsize x the largest clique's states),
    # beside two [B, separator] messages per separator: fitted to peaks
    # measured on the card (chip_smoke.py phase memory_estimates; PERF.md)
    ROW_CLIQUES = {"posterior": 2.6, "map": 1.7}

    def max_feasible_batch(
        self, budget_bytes: int = 8 << 30,
        live_messages: Optional[int] = None,
        analysis: Optional[dict] = None, task: str = "posterior",
    ) -> int:
        """Largest power-of-two evidence batch whose call keeps the device
        memory it allocates, the standing potentials and what the card
        keeps beside them for the kernel (``_kept_bytes_bound``) included,
        inside ``budget_bytes``.

        On models with huge cliques and separators the batch size, not the
        model, is what overflows memory.  By default the bytes of one row
        are reckoned for eager torch: ``ROW_CLIQUES[task]`` times the
        largest clique's states (the products of the planned pairwise
        einsums on it) plus two messages per separator, in the storage
        dtype; a float32 tree-MAP on the card reckons no clique term (its
        fused collect holds no [B, clique] tensor) but the largest
        separator's 8-byte keys, which the kernel folds into while that
        separator's message and pointers exist.  ``task`` is "posterior"
        (``posterior_batch``) or "map" (``map_assignment_batch``).
        ``live_messages`` is accepted for the
        JAX package's signature and must be None: its reckoning (n tensors
        of [B, max_sep_states] alive, nothing standing) under-counts what
        eager torch keeps several times over.

        ``analysis``: optionally ``{"batch": B0, "temp_bytes": peak}`` from
        a measured step at batch B0 (``torch.cuda.max_memory_allocated``
        around one call) -- then the estimate starts from the MEASURED peak
        and only extrapolates the marginal rows:
        B0 + (budget - peak) / per_query_bytes.  Returns at least 1."""
        st = self.plan.stats()
        itemsize = torch.empty((), dtype=self.storage_dtype()).element_size()
        if live_messages is not None:
            raise ValueError(
                "live_messages reckons XLA's buffer reuse and under-counts "
                "eager torch's peak; pass analysis= from a measured step")
        seps = sum(_vars_states(self.plan.sizes, vs)
                   for vs in self.plan.tree.separators)
        cliques, keys = self.ROW_CLIQUES[task], 0
        if task == "map" and self._chain_layout() is None:
            from .ops import map_collect

            if map_collect.engages(self.compute_dtype, self.device):
                # the fused collect: no [B, clique] tensor; the largest
                # separator's 64-bit keys beside its message and pointers
                cliques, keys = 0.0, 8 * st["max_sep_states"]
        per_query = itemsize * int(
            cliques * st["max_clique_states"] + 2 * seps) + keys
        held = itemsize * st["total_clique_states"] + self._kept_bytes_bound()
        if analysis is not None:
            headroom = budget_bytes - int(analysis["temp_bytes"])
            if headroom < 0:
                b = max(1, int(analysis["batch"]) // 2)
            else:
                b = int(analysis["batch"]) + int(headroom // per_query)
        else:
            b = max(1, int((budget_bytes - held) // per_query))
        b = max(1, b)
        return 1 << (b.bit_length() - 1)

    def incremental(self, mask_batch) -> "IncrementalSession":
        """Open an incremental-evidence serving session: one collect pass is
        cached, and subsequent single/few-variable evidence deltas reuse
        every unaffected message -- O(tree depth) work per delta instead of
        O(cliques) (``incremental.IncrementalSession``).

        ``mask_batch``: dict {var label: [B, size_v] linear masks}, the
        base evidence; unlisted variables are unobserved.  On a
        ``shard_batch`` engine each device opens a session on its rows
        (``incremental.RowShardedSession``)."""
        from .incremental import IncrementalSession, RowShardedSession

        if self._mask_sharding is not None:
            devs, blocks = self._row_split(mask_batch)
            return RowShardedSession(
                [self._replica(d).incremental(m) for d, m in zip(devs, blocks)],
                devs[0])
        return IncrementalSession(self, mask_batch)

    # -- parallelism over a mesh (parallel/) --
    def shard_batch(self, mesh, axis: str = "batch") -> "Engine":
        """Data parallelism: every batched query (``posterior_batch``, also
        with ``chunk=``, ``query_batch``, ``entropy_batch``,
        ``joint_marginal_batch``, ``map_assignment_batch``,
        ``top_k_assignments_batch``, ``incremental``) splits its evidence
        rows over the devices of ``axis`` of ``mesh`` (contiguous blocks,
        sizes differing by at most one).  Each device serves its rows on
        its own cached replica of the engine and potentials; the results
        are concatenated on the axis's first device."""
        self._mask_sharding = Sharding(mesh, (axis, None))
        self._replicas = {}
        return self

    def shard_model(self, mesh, min_states: Optional[int] = None,
                    shard_batch: bool = False) -> "Engine":
        """Tensor parallelism: serve cliques of at least ``min_states``
        states (default ``config.DEFAULT.tp_min_states``) split over the
        ``model`` axis of ``mesh`` instead of refusing them in
        ``check_feasible``: each such potential is stored flat-sharded over
        the axis's devices, and every contraction the general program makes
        on it runs as the factored big-clique contraction over blocks of R1,
        one per model device, summed in a fixed order
        (``parallel.tp.tp_contract_fn``; on the card every block launches
        the CUDA kernel).  The feasibility cap scales to
        ``MAX_CLIQUE_STATES * n_model``.  ``shard_batch=True`` also splits
        those contractions' rows over the mesh's ``batch`` axis (B must
        then divide by its size).  Sum-product engines only; call before
        ``set_potentials`` for a model above the single-device cap."""
        if self.semiring != SUM_PRODUCT:
            raise ValueError(
                "shard_model requires the sum_product semiring (the TP "
                "route is a linear factored contraction)"
            )
        self._model_mesh = mesh
        self._tp_min_states = (
            _CFG.tp_min_states if min_states is None else int(min_states))
        self._tp_shard_batch = bool(shard_batch)
        # programs built without the sharded route are stale
        self._programs.clear()
        self._pots_prog = None
        self._replicas = {}
        if self._pots_np is not None:
            self._pots = self._place_pots(self._pots_np)
        return self

    def shard_sequence(self, mesh, axis: str = "batch",
                       min_len: int = 2048) -> "Engine":
        """Sequence parallelism for chain plans: on a uniform chain of at
        least ``min_len`` cliques, ``posterior_batch`` in auto mode takes
        the log-depth program
        (``scan_executor.chain_posterior_parallel_program``) with the chain
        steps split over the devices of ``axis`` of ``mesh``.  It does K^3
        work per step against the sequential program's K^2, so shorter
        chains keep the sequential program; other plans ignore the
        setting."""
        self._seq_mesh, self._seq_axis = mesh, axis
        self._seq_min_len = int(min_len)
        self._programs.clear()
        self._chain_A = None
        self._replicas = {}
        return self

    def _tp(self):
        """The sharded route's settings for the general program, or None."""
        if self._model_mesh is None:
            return None
        return (self._model_mesh, self._tp_min_states, self._tp_shard_batch,
                self._tp_notes, self.device)

    def _feasible_cap(self) -> Optional[int]:
        if self._model_mesh is None:
            return None
        return MAX_CLIQUE_STATES * int(self._model_mesh.shape[MODEL_AXIS])

    def _replica(self, device) -> "Engine":
        """This engine's twin on ``device`` (same plan, dtype, potentials,
        model and sequence sharding), built once."""
        key = str(device)
        eng = self._replicas.get(key)
        if eng is None:
            eng = Engine(self.plan, self.semiring, device=device,
                         dtype=self.dtype)
            eng._tp_notes = self._tp_notes
            if self._model_mesh is not None:
                eng.shard_model(self._model_mesh, self._tp_min_states,
                                self._tp_shard_batch)
            if self._seq_mesh is not None:
                eng.shard_sequence(self._seq_mesh, self._seq_axis,
                                   self._seq_min_len)
            eng.set_clique_potentials(self._require_pots_np())
            self._replicas[key] = eng
        return eng

    def _row_split(self, mask_batch):
        """(devices, row blocks of ``mask_batch``) along the batch mesh
        axis: a dict or list of [B, size_v] masks cut into contiguous row
        blocks, one per device (fewer when B is smaller)."""
        mesh, (axis, _) = self._mask_sharding.mesh, self._mask_sharding.spec
        devs = mesh.local_devices(axis)
        items = list(mask_batch.values()) if isinstance(mask_batch, dict) \
            else list(mask_batch)
        if not items:
            return devs[:1], [mask_batch]
        blocks = []
        for rows in row_blocks(int(items[0].shape[0]), len(devs)):
            if isinstance(mask_batch, dict):
                blocks.append({k: v[rows] for k, v in mask_batch.items()})
            else:
                blocks.append([m[rows] for m in mask_batch])
        return devs[:len(blocks)], blocks

    def _rows_sharded(self, method: str, mask_batch, **kwargs):
        """``method`` of each device's replica on its rows; the results
        concatenated along the rows on the first device."""
        devs, blocks = self._row_split(mask_batch)
        outs = [getattr(self._replica(d), method)(mask_batch=m, **kwargs)
                for d, m in zip(devs, blocks)]
        return cat_rows(outs, devs[0])


def cat_rows(parts, device):
    """Concatenate per-device results along their rows on ``device``: a
    tensor along axis 0, a ``StackedPosteriors`` along its batch axis, a
    tuple entry by entry, any other sequence (per-variable posteriors)
    variable by variable."""
    from .scan_executor import StackedPosteriors

    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, StackedPosteriors):
        return StackedPosteriors.cat(parts, device)
    if isinstance(first, tuple):
        return tuple(cat_rows([p[k] for p in parts], device)
                     for k in range(len(first)))
    return [cat_rows([p[v] for p in parts], device) for v in range(len(first))]
