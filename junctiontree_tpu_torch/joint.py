"""Exact joint marginals over ARBITRARY variable sets (out-of-clique queries;
counterpart of ``junctiontree_tpu/joint.py``).

For any variable set Q, the joint P(Q | evidence) is exact via the
calibrated-tree factorization

    P(x) = prod_C b_C(x_C) / prod_S b_S(x_S)        (all beliefs calibrated)

restricted to the minimal (Steiner) subtree of cliques spanning Q's home
cliques: every clique outside it marginalizes to 1 after the division.  The
subtree is eliminated leaves-first, carrying each node's parent-separator
scope PLUS the Q variables seen so far -- so the intermediate scope stays
|sep| + |Q| rather than the union of all clique scopes (the path between
two far-apart query variables can cross many cliques).

Division is guarded (zeros stay zeros).  Probability semirings only
(sum_product / log_sum_exp).

This also powers information-theoretic queries: ``Engine.mutual_information``
computes I(X;Y | evidence) from the exact pairwise joint.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .ops.semirings import SUM_PRODUCT, Semiring, _broadcast_to_scope
from .schedule import Plan


def steiner_subtree(plan: Plan, qids: Sequence[int]):
    """Minimal subtree of the clique tree spanning the home cliques of
    ``qids``.  Returns (nodes, root, children) with children restricted to
    the subtree; root is the subtree node closest to the tree root."""
    tree = plan.tree
    targets = {plan.var_to_clique[q] for q in qids}
    # union of root-paths, then prune non-target leaves
    nodes: Set[int] = set()
    for c in targets:
        while c != -1 and c not in nodes:
            nodes.add(c)
            c = tree.parent[c]
    changed = True
    while changed:
        changed = False
        for c in list(nodes):
            if c in targets:
                continue
            kids_in = [k for k, _ in tree.children[c] if k in nodes]
            parent_in = tree.parent[c] in nodes
            if len(kids_in) + (1 if parent_in else 0) <= 1:
                nodes.remove(c)
                changed = True
    root = min(nodes, key=lambda c: tree.topo_order.index(c))
    children = {
        c: [(k, s) for k, s in tree.children[c] if k in nodes]
        for c in nodes
    }
    return nodes, root, children


def _guarded_divide(semiring: Semiring, num, den):
    """num / den in the semiring, zeros staying zeros: where the divisor is
    the semiring zero the result is the semiring zero."""
    if semiring.is_log:
        return torch.where(
            torch.isneginf(den), torch.full_like(num, -float("inf")), num - den
        )
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def _check_semiring(semiring: Semiring) -> None:
    if semiring.name not in ("sum_product", "log_sum_exp"):
        raise ValueError(
            "joint marginals need a probability semiring "
            "(sum_product or log_sum_exp), not %r" % semiring.name
        )


def joint_marginal_program(
    plan: Plan,
    semiring: Semiring,
    qids: Sequence[int],
    max_states: int = 1 << 24,
):
    """Build ``fn(clique_beliefs, sep_beliefs) -> unnormalized joint over
    ``qids`` (axes in qids order)`` on CALIBRATED beliefs.

    Raises ValueError if any elimination intermediate would exceed
    ``max_states`` states (scope = parent separator + query vars below)."""
    _check_semiring(semiring)
    qids = list(qids)
    tree = plan.tree
    cvars = plan.clique_vars
    svars = plan.sep_vars
    # static: post-order over the subtree + per-node output scope
    order, root, children, out_scope = _steiner_order_scopes(
        plan, qids, max_states
    )
    # the shared analysis projects the root onto sorted(qids); the caller's
    # axis order is restored by a final permute
    sorted_q = out_scope[root]
    out_perm = [sorted_q.index(q) for q in qids]

    def fn(clique_beliefs, sep_beliefs):
        msgs: Dict[int, torch.Tensor] = {}
        for c in order:
            ops = [clique_beliefs[c]]
            ovs: List[List[int]] = [list(cvars[c])]
            if c != root:
                # divide this node's belief by its parent-separator belief
                # BEFORE contracting (cond_c = b_c / b_sep factorization)
                s = tree.parent_sep[c]
                den = _broadcast_to_scope(sep_beliefs[s], svars[s], cvars[c])
                ops[0] = _guarded_divide(semiring, ops[0], den)
            for k, _ in children[c]:
                ops.append(msgs.pop(k))
                ovs.append(out_scope[k])
            msgs[c] = semiring.contract(ops, ovs, out_scope[c])
        return msgs[root].permute(out_perm)

    return fn


def _scope_states(plan: Plan, scope) -> int:
    states = 1
    for v in scope:
        states *= plan.sizes[v]
    return states


def _steiner_order_scopes(plan: Plan, qids, max_states):
    """Shared static analysis: post-order + per-node output scope for the
    Steiner elimination, with the intermediate-size cap check.  Iterative:
    a query across a 5,000-clique chain must not hit Python's recursion
    limit."""
    qset = set(qids)
    tree = plan.tree
    cvars, svars = plan.clique_vars, plan.sep_vars
    nodes, root, children = steiner_subtree(plan, qids)
    order: List[int] = []
    stack: List[Tuple[int, bool]] = [(root, False)]
    while stack:
        c, done = stack.pop()
        if done:
            order.append(c)
            continue
        stack.append((c, True))
        for k, _ in children[c]:
            stack.append((k, False))
    q_below: Dict[int, Set[int]] = {}
    out_scope: Dict[int, List[int]] = {}
    for c in order:
        qb = set(cvars[c]) & qset
        for k, _ in children[c]:
            qb |= q_below[k]
        q_below[c] = qb
        if c != root:
            sep = svars[tree.parent_sep[c]]
            scope = sorted(set(sep) | qb)
        else:
            scope = sorted(qset)
        out_scope[c] = list(scope)
        states = _scope_states(plan, scope)
        if states > max_states:
            raise ValueError(
                f"joint_marginal over {len(qids)} variables needs a "
                f"{states:,}-state intermediate at clique {c} (cap "
                f"{max_states:,}); query fewer/closer variables or raise "
                f"max_states"
            )
    return order, root, children, out_scope


def batched_joint_marginal_program(
    plan: Plan,
    semiring: Semiring,
    qids: Sequence[int],
    max_states: int = 1 << 24,
    observed: Optional[Sequence[int]] = None,
):
    """Build ``fn(pots, masks) -> (tables [B, *sizes(qids)] linear
    NORMALIZED per element, Z [B] linear)`` -- the batch-aware form of
    ``joint_marginal_program``.

    Runs the executor's batch-aware routed up/down message program ONCE (no
    ``[B, clique_states]`` materialization; on a big clique every
    contraction below goes through the factored big-clique route), then
    eliminates the Steiner subtree with batch-labelled routed contractions.
    Per-message rescaling (linear semiring) contributes only a per-element
    constant factor, which the final per-element normalization removes.

    Impossible evidence (Z_b = 0) yields an all-zero table for that
    element, matching the unbatched path.

    ``masks`` is the list of ``[B, size_v]`` mask tensors aligned with
    ``observed`` (var ids; None = all variables)."""
    from .executor import BATCH, BatchedProgramBuilder

    _check_semiring(semiring)
    qids = list(qids)
    tree = plan.tree
    svars = plan.sep_vars
    order, root, children, out_scope = _steiner_order_scopes(
        plan, qids, max_states
    )
    rescale = semiring == SUM_PRODUCT
    builder = BatchedProgramBuilder(plan, semiring, observed, rescale=rescale)
    sorted_q = out_scope[root]
    perm = [sorted_q.index(q) for q in qids]

    def fn(pots, masks):
        B = int(masks[0].shape[0]) if masks else 1
        # the joint needs messages + Z, not the per-variable marginal phase
        st = builder.run(pots, masks, kinds=("up", "down", "z"))
        msgs: Dict[int, torch.Tensor] = {}
        msgs_b: Dict[int, bool] = {}
        for c in order:
            ops, ovs = builder._node_ops(c, st, pots, masks)
            for k, _ in children[c]:
                ops.append(msgs.pop(k))
                ovs.append(([BATCH] if msgs_b.pop(k) else []) + out_scope[k])
            scope = out_scope[c]
            num, b = builder._contract(ops, ovs, scope)
            if c != root:
                # divide by the parent-separator belief (= up x down in
                # Shafer-Shenoy messages); sep is inside scope, so the
                # division commutes with the marginalization already done
                # by the contraction above
                sep = list(svars[tree.parent_sep[c]])
                den, den_b = builder._contract(
                    [st[("up", c)], st[("down", c)]],
                    [builder._upv(c), builder._downv(c)],
                    sep,
                )
                numv = ([BATCH] if b else []) + scope
                denv = ([BATCH] if den_b else []) + sep
                b = b or den_b
                full = ([BATCH] if b else []) + scope
                num = _guarded_divide(
                    semiring,
                    _broadcast_to_scope(num, numv, full),
                    _broadcast_to_scope(den, denv, full),
                )
            msgs[c] = num
            msgs_b[c] = b
        table = msgs[root]
        table = table.reshape(
            (table.shape[0] if msgs_b[root] else 1), -1
        ).expand(B, -1)
        # normalize per element (guards impossible evidence: zero table)
        if semiring.is_log:
            lse = torch.logsumexp(table, dim=1, keepdim=True)
            ok = torch.isfinite(lse)
            table = torch.where(
                ok, torch.exp(table - torch.where(ok, lse, 0.0)), 0.0
            )
        else:
            tot = table.sum(dim=1, keepdim=True)
            table = torch.where(
                tot > 0, table / torch.where(tot > 0, tot, 1.0), 0.0
            )
        table = table.reshape([B] + [plan.sizes[q] for q in sorted_q])
        table = table.permute([0] + [1 + p for p in perm])
        z = st[("z",)]
        zlin = torch.exp(z) if (rescale or semiring.is_log) else z
        return table, zlin

    return fn


def mutual_information_from_joint(joint) -> float:
    """I(X;Y) in nats from a (possibly unnormalized) LINEAR joint table
    over exactly two axes."""
    if isinstance(joint, torch.Tensor):
        joint = joint.detach().cpu().numpy()
    p = np.asarray(joint, dtype=np.float64)
    z = p.sum()
    if not np.isfinite(z) or z <= 0:
        raise ValueError("joint table does not normalize (Z=%r)" % z)
    p = p / z
    px = p.sum(axis=1, keepdims=True)
    py = p.sum(axis=0, keepdims=True)
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / (px * py)[mask])))
