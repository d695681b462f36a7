"""Execute phase: static-schedule belief propagation in PyTorch.

Counterpart of ``junctiontree_tpu/executor.py``.  The collect/distribute
schedule is unrolled over the rooted tree (``Plan.tree.topo_order``) into a
static sequence of contractions; clique potentials are broadcast to full
clique scope; distribute recomputes leave-one-out products (no division, so
structural zeros are safe); evidence is a per-variable mask combined into
one clique per variable (``Plan.var_to_clique``).

Two paths:

* the unbatched parity path (``propagate_cliques``; ``Engine.propagate`` and
  ``Engine.query``), which every batched result is checked against;
* the serving path ``Engine.posterior_batch``: the batch-aware, rescaled
  message program built by :class:`BatchedProgramBuilder`.  Clique potentials
  stay unbatched and only masks and messages carry the batch axis; large
  cliques go through the factored big-clique contraction (the CUDA kernel on
  the card, ``ops/factored_contract.py``), everything else through the
  planned einsum of ``ops/semirings.py``.

PyTorch runs eagerly, so there is no jit and no program cache beyond the
builder's static schedule.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import DEFAULT as _CFG
from .ops.factored_contract import big_clique_sep_message
from .ops.semirings import SUM_PRODUCT, Semiring, _broadcast_to_scope
from .schedule import Plan


def _combine_into_scope(
    acc: torch.Tensor,
    scope: Sequence[int],
    x: torch.Tensor,
    x_vars: Sequence[int],
) -> torch.Tensor:
    return acc * _broadcast_to_scope(x, x_vars, scope)


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


def evaluate_cliques_np(
    plan: Plan,
    factor_values: Sequence[np.ndarray],
    dtype=np.float64,
    max_states: Optional[int] = None,
) -> List[np.ndarray]:
    """Initial clique potentials on the host: product of assigned factors,
    broadcast to the full clique shape (Hugin initialization)."""
    check_feasible(plan, max_states)
    if len(factor_values) != len(plan.factors):
        raise ValueError(
            "expected %d factor value arrays, got %d"
            % (len(plan.factors), len(factor_values))
        )
    pots: List[np.ndarray] = []
    for c in range(plan.tri.num_cliques):
        pots.append(np.ones(plan.clique_shape(c), dtype=dtype))
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
            pots[c] = pots[c] * val
            continue
        cvars = plan.clique_vars[c]
        pos = {v: i for i, v in enumerate(fvars)}
        perm = [pos[v] for v in cvars if v in pos]
        x = np.transpose(val, perm)
        shape = [(plan.sizes[v] if v in pos else 1) for v in cvars]
        pots[c] = pots[c] * x.reshape(shape)
    return pots


def apply_masks(
    plan: Plan,
    clique_pots: Sequence[torch.Tensor],
    masks: Sequence[torch.Tensor],
) -> List[torch.Tensor]:
    """Combine per-variable evidence masks (one [size_v] vector per variable
    id) into each variable's designated clique."""
    pots = list(clique_pots)
    for v, m in enumerate(masks):
        c = plan.var_to_clique[v]
        pots[c] = _combine_into_scope(pots[c], plan.clique_vars[c], m, [v])
    return pots


def propagate_cliques(
    plan: Plan,
    clique_pots: Sequence[torch.Tensor],
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
        up[c] = SUM_PRODUCT.contract(
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
                acc, cvars[p], down[p], svars[tree.parent_sep[p]]
            )
        d = len(kids)
        bcast = [
            _broadcast_to_scope(up[k], svars[s], cvars[p]) for k, s in kids
        ]
        if d == 1:
            k, s = kids[0]
            down[k] = SUM_PRODUCT.contract([acc], [cvars[p]], svars[s])
            continue
        prefix: List[Optional[torch.Tensor]] = [None] * d
        suffix: List[Optional[torch.Tensor]] = [None] * d
        run = None
        for i in range(d):
            prefix[i] = run
            run = bcast[i] if run is None else run * bcast[i]
        run = None
        for i in range(d - 1, -1, -1):
            suffix[i] = run
            run = bcast[i] if run is None else run * bcast[i]
        for i, (k, s) in enumerate(kids):
            loo = acc
            if prefix[i] is not None:
                loo = loo * prefix[i]
            if suffix[i] is not None:
                loo = loo * suffix[i]
            down[k] = SUM_PRODUCT.contract([loo], [cvars[p]], svars[s])

    # ---- beliefs ----
    clique_beliefs: List[Optional[torch.Tensor]] = [None] * tree.num_cliques
    for c in tree.topo_order:
        acc = clique_pots[c]
        if c != tree.root:
            acc = _combine_into_scope(
                acc, cvars[c], down[c], svars[tree.parent_sep[c]]
            )
        for k, s in tree.children[c]:
            acc = _combine_into_scope(acc, cvars[c], up[k], svars[s])
        clique_beliefs[c] = acc

    sep_beliefs: List[Optional[torch.Tensor]] = [None] * len(svars)
    for c in tree.topo_order:
        if c == tree.root:
            continue
        s = tree.parent_sep[c]
        sep_beliefs[s] = up[c] * down[c]

    return clique_beliefs, sep_beliefs


def factor_marginals(
    plan: Plan,
    clique_beliefs: Sequence[torch.Tensor],
) -> List[torch.Tensor]:
    """Project consistent clique beliefs back onto each factor's variables.
    Empty-scope factors marginalize the root belief to a scalar (= Z)."""
    out: List[torch.Tensor] = []
    for f, fvars in enumerate(plan.factors):
        c = plan.tri.factor_to_maxclique[f]
        if c < 0:
            c = plan.tree.root
        out.append(
            SUM_PRODUCT.contract([clique_beliefs[c]], [plan.clique_vars[c]], fvars)
        )
    return out


def var_marginals(
    plan: Plan,
    clique_beliefs: Sequence[torch.Tensor],
) -> List[torch.Tensor]:
    """Per-variable unnormalized marginals, one [size_v] vector per var id."""
    out: List[torch.Tensor] = []
    for v in range(plan.num_vars):
        c = plan.var_to_clique[v]
        out.append(
            SUM_PRODUCT.contract([clique_beliefs[c]], [plan.clique_vars[c]], [v])
        )
    return out


def partition(
    plan: Plan,
    clique_beliefs: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Normalization constant: the root belief fully marginalized."""
    r = plan.tree.root
    return SUM_PRODUCT.contract([clique_beliefs[r]], [plan.clique_vars[r]], [])


def all_ones_masks(plan: Plan) -> List[np.ndarray]:
    """No-evidence masks."""
    return [np.ones((s,), dtype=np.float32) for s in plan.sizes]


def evidence_to_masks(
    plan: Plan,
    evidence: Dict[Hashable, int],
) -> List[np.ndarray]:
    """Dict {var label: observed state} -> per-variable mask vectors:
    entries inconsistent with the evidence become zero."""
    masks = all_ones_masks(plan)
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
        m = np.zeros((plan.sizes[v],), dtype=np.float32)
        m[int(state)] = 1.0
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


def _bcontract(operands, operand_vars, out_vars):
    """Contract mixed batched/unbatched operands; output gets the batch axis
    iff any operand has it."""
    batched = any(vs and vs[0] == BATCH for vs in operand_vars)
    out = ([BATCH] + list(out_vars)) if batched else list(out_vars)
    return SUM_PRODUCT.contract(operands, operand_vars, out), batched


def _try_big_clique_route(plan, ops, ovs, out_vars, min_states):
    """Route a collect/distribute/marginal contraction through the factored
    big-clique contraction when the clique has at least ``min_states``
    states and every batched operand is either a single-variable mask
    (evidence) or a child message whose scope doesn't cross the
    output-separator boundary.  Returns (result, batched) or None."""
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
    if not unbatched or not (batched or msgs):
        return None
    scope: List[int] = []
    for _, v in unbatched:
        for x in v:
            if x not in scope:
                scope.append(x)
    if _vars_states(plan.sizes, scope) < min_states:
        return None
    if any(x not in scope for x in out_vars):
        return None
    if any(x not in scope for _, x in batched):
        return None
    out_set = set(out_vars)
    for vs, _ in msgs:
        if any(x not in scope for x in vs):
            return None
        # a message must factor entirely into the kernel weights (rest
        # scope) or entirely into the output (separator scope)
        if not (all(x in out_set for x in vs)
                or all(x not in out_set for x in vs)):
            return None
    pot = (
        unbatched[0][0]
        if len(unbatched) == 1 and unbatched[0][1] == scope
        else SUM_PRODUCT.contract(
            [o for o, _ in unbatched], [v for _, v in unbatched], scope
        )
    )
    masks: Dict[int, torch.Tensor] = {}
    for o, x in batched:
        masks[x] = o if x not in masks else masks[x] * o
    out = big_clique_sep_message(pot, scope, masks, list(out_vars), msgs=msgs)
    return out, True


def routed_contract(plan, ops, ovs, outv, *, min_states):
    """One contraction through the routing ladder: the factored big-clique
    contraction, else the planned batched einsum.  Returns (result,
    batched)."""
    routed = _try_big_clique_route(plan, ops, ovs, outv, min_states)
    if routed is not None:
        return routed
    return _bcontract(ops, ovs, outv)


_PROG_TINY = 1e-38


class BatchedProgramBuilder:
    """Step-structured builder for the rescaled, batch-aware sum-product
    propagate program.

    The program is a STATIC schedule of steps — one collect contraction per
    non-root clique, one distribute step per parent, one marginal per
    variable, one partition step — over a dict of named tensors.  Whether
    each intermediate carries the batch axis is decided statically (a
    contraction output is batched iff any operand is batched), and every
    contraction checks it.  Every message is divided by its max and the
    collect offsets accumulate into logZ.  ``full()`` returns the program as
    a function."""

    def __init__(self, plan: Plan, observed: Optional[Sequence[int]] = None):
        self.plan = plan
        tree = plan.tree
        if observed is None:
            observed = list(range(plan.num_vars))
        self.observed = list(observed)
        self.mask_slot = {v: i for i, v in enumerate(self.observed)}
        cmv: List[List[int]] = [[] for _ in range(tree.num_cliques)]
        for v in self.observed:
            cmv[plan.var_to_clique[v]].append(v)
        self.clique_mask_vars = cmv
        self.min_states = _CFG.big_clique_min_states
        # cliques up to this size materialize their belief once in the
        # marginal phase; bigger ones contract per variable so
        # [B, clique_states] never materializes
        self.BELIEF_STATES_CAP = 1 << 12
        self._flags()
        self.steps = (
            [("up", c) for c in reversed(tree.topo_order) if c != tree.root]
            + [("down", p) for p in tree.topo_order if tree.children[p]]
            + [("marg", v) for v in range(plan.num_vars)]
            + [("z", None)]
        )

    def _states(self, c: int) -> int:
        return _vars_states(self.plan.sizes, self.plan.clique_vars[c])

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
            base = has_mask[p] or (p != tree.root and down_b[p])
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
            self.plan, ops, ovs, outv, min_states=self.min_states
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

    def _rescale_msg(self, st, m, batched, track):
        """Divide a message by its max (per batch row when batched); the
        collect pass accumulates log(max) into the logZ offset."""
        if batched:
            s = m.reshape(m.shape[0], -1).amax(dim=1).clamp_min(_PROG_TINY)
            if track:
                st[("logoff",)] = st[("logoff",)] + torch.log(s)
            return m / s.reshape((-1,) + (1,) * (m.dim() - 1))
        s = m.max().clamp_min(_PROG_TINY)
        if track:
            st[("logoff",)] = st[("logoff",)] + torch.log(s)
        return m / s

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

    def _run_step(self, s, st, pots, masks, B):
        plan, tree = self.plan, self.plan.tree
        svars = plan.sep_vars
        kind, c = s
        if kind == "up":
            ops, ovs = self._clique_ops(c, pots, masks)
            for k, _ in tree.children[c]:
                ops.append(st[("up", k)])
                ovs.append(self._upv(k))
            out, b = self._contract(ops, ovs, svars[tree.parent_sep[c]])
            st[("up", c)] = self._rescale_msg(st, out, b, True)
        elif kind == "down":
            p = c
            kids = tree.children[p]
            pops, povs = self._clique_ops(p, pots, masks)
            if p != tree.root:
                pops.append(st[("down", p)])
                povs.append(self._downv(p))
            for i, (k, sep) in enumerate(kids):
                ops, ovs = list(pops), list(povs)
                for j, (k2, _) in enumerate(kids):
                    if j != i:
                        ops.append(st[("up", k2)])
                        ovs.append(self._upv(k2))
                out, b = self._contract(ops, ovs, svars[sep])
                st[("down", k)] = self._rescale_msg(st, out, b, False)
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
            root = tree.root
            if ("bel", root) in st:
                zv = ([BATCH] if self.node_b[root] else []) + list(
                    plan.clique_vars[root]
                )
                z, b = self._contract([st[("bel", root)]], [zv], [])
            else:
                rops, rovs = self._node_ops(root, st, pots, masks)
                z, b = self._contract(rops, rovs, [])
            if not b:
                z = z.reshape(()).expand(B)
            # logZ = log(z_scaled) + accumulated collect offsets
            # (impossible evidence: z_scaled == 0 -> logZ = -inf)
            z = torch.where(
                z > 0, torch.log(z.clamp_min(_PROG_TINY)),
                torch.full_like(z, -float("inf")),
            )
            st[("z",)] = z + st[("logoff",)].expand(z.shape)
        else:  # pragma: no cover
            raise AssertionError(kind)

    def full(self):
        """``fn(pots, masks) -> (marginals list, logZ [B])``; the marginals
        are unnormalized but bounded."""

        def fn(pots: Sequence[torch.Tensor], masks: Sequence[torch.Tensor]):
            st: Dict[tuple, torch.Tensor] = {}
            B = masks[0].shape[0] if masks else 1
            ref = pots[0]
            st[("logoff",)] = torch.zeros((), dtype=ref.dtype, device=ref.device)
            for s in self.steps:
                self._run_step(s, st, pots, masks, B)
            margs = [st[("marg", v)] for v in range(self.plan.num_vars)]
            return margs, st[("z",)]

        return fn


def batched_propagate_program(
    plan: Plan, observed: Optional[Sequence[int]] = None
):
    """Build ``fn(pots, masks) -> (var_marginals [B,size_v] list, logZ [B])``.

    ``pots`` are unbatched clique potentials; ``masks`` is a list aligned
    with ``observed`` (var ids), each [B, size_v].  Only observed variables
    carry masks.  Every message is divided by its max and the collect
    offsets accumulate into logZ; the marginals are unnormalized."""
    return BatchedProgramBuilder(plan, observed).full()


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


class Engine:
    """Inference engine for one compiled Plan on one torch device.

    ``set_potentials`` precomputes clique potentials once; ``query`` and
    ``posterior_batch`` then serve evidence against them.  ``device`` and
    ``dtype`` place the potentials, masks and messages (default: CUDA
    device 0 and ``config.DEFAULT.storage_dtype``; pass ``device="cpu"`` to
    run on the CPU)."""

    def __init__(
        self,
        plan: Plan,
        semiring: Semiring = SUM_PRODUCT,
        *,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        if semiring is not SUM_PRODUCT:
            raise NotImplementedError(
                f"semiring {semiring.name!r} is not ported yet (ROADMAP.md)"
            )
        if dtype is None:
            dtype = getattr(torch, _CFG.storage_dtype)
        if dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(
                f"dtype {dtype} is not supported yet: use torch.float32 or "
                "torch.float64 (bf16 storage is ROADMAP.md Queue 1 item 5)"
            )
        self.plan = plan
        self.semiring = semiring
        self.device = resolve_device(device)
        self.dtype = dtype
        self._pots: Optional[List[torch.Tensor]] = None
        self._programs: Dict[tuple, BatchedProgramBuilder] = {}

    def _place(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- reference-parity path: values in, unnormalized factor marginals out --
    def propagate(self, values: Sequence[np.ndarray]) -> List[np.ndarray]:
        pots = evaluate_cliques_np(
            self.plan, [np.asarray(v, dtype=np.float64) for v in values]
        )
        beliefs, _ = propagate_cliques(
            self.plan, [self._place(p) for p in pots]
        )
        return [x.cpu().numpy() for x in factor_marginals(self.plan, beliefs)]

    # -- serving: precompute potentials once, then mask-only queries --
    def set_potentials(self, values: Sequence[np.ndarray]) -> "Engine":
        from .utils.timing import TIMERS

        vals = [np.asarray(v, dtype=np.float64) for v in values]
        with TIMERS.phase("engine.evaluate"):
            pots = evaluate_cliques_np(self.plan, vals)
        return self.set_clique_potentials(pots)

    def set_clique_potentials(self, pots: Sequence[np.ndarray]) -> "Engine":
        """Install evaluated clique potentials (one array per clique, in
        ``plan.clique_vars`` axis order) without re-evaluating factors."""
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
        self._pots = [self._place(p) for p in pots]
        return self

    def _require_pots(self) -> List[torch.Tensor]:
        if self._pots is None:
            raise RuntimeError("call set_potentials(values) before querying")
        return self._pots

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
        masks = evidence_to_masks(self.plan, evidence or {})
        mpots = apply_masks(self.plan, pots, [self._place(m) for m in masks])
        beliefs, _ = propagate_cliques(self.plan, mpots)
        margs = [m.cpu().numpy() for m in var_marginals(self.plan, beliefs)]
        zlin = float(partition(self.plan, beliefs))
        if normalize:
            margs = [m / m.sum() if m.sum() != 0 else m for m in margs]
        return margs, zlin

    def _masks_to_program_args(self, mask_batch):
        if isinstance(mask_batch, dict):
            ids = sorted(self.plan.table.id_of(k) for k in mask_batch)
            by_id = {self.plan.table.id_of(k): v for k, v in mask_batch.items()}
            masks = [self._place(by_id[v]) for v in ids]
        else:
            ids = list(range(self.plan.num_vars))
            masks = [self._place(m) for m in mask_batch]
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

    def posterior_batch(self, mask_batch, mode: str = "auto"):
        """Serving path: normalized per-variable posteriors + log-partition.

        ``mask_batch`` is a dict {var label: [B, size_v] mask} for the
        observed variables (evidence-free parts of the tree then run
        unbatched), or a list of [B, size_v] masks for every variable id;
        numpy arrays or tensors.  Runs the rescaled batch-aware program:
        every message is divided by its max and the collect offsets
        accumulate into logZ, so the result is stable where plain linear
        space would over- or underflow.

        ``mode``: "auto" and "general" both run that program; the chain and
        level-fused programs of the JAX package are not ported yet, and
        "fused" raises ``NotImplementedError``.

        Returns (posteriors: list over var ids of [B, size_v] tensors, logZ:
        [B] tensor) on the engine's device.  Impossible evidence gives zero
        posteriors and logZ = -inf."""
        if mode == "fused":
            raise NotImplementedError(
                "the level-fused serving program is not ported yet "
                "(ROADMAP.md Queue 1 item 7); use mode='general'"
            )
        if mode not in ("auto", "general"):
            raise ValueError(f"unknown mode {mode!r}")
        pots = self._require_pots()
        ids, masks = self._masks_to_program_args(mask_batch)
        builder = self._programs.get(ids)
        if builder is None:
            builder = BatchedProgramBuilder(self.plan, list(ids))
            self._programs[ids] = builder
        margs, logz = builder.full()(pots, masks)
        post = [m / m.sum(dim=-1, keepdim=True).clamp_min(_PROG_TINY) for m in margs]
        return post, logz
