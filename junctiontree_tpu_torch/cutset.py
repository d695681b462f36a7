"""Cutset conditioning: exact inference past the treewidth wall
(counterpart of ``junctiontree_tpu/cutset.py``).

Pearl's classic escape hatch for dense networks, with the cutset's joint
states as ANOTHER BATCH AXIS.  Conditioning on a cutset C removes its
variables from the graph, so the reduced model triangulates with far smaller
cliques *and separators* (serving memory is B x sep_states, see
``Engine.max_feasible_batch``); each cutset assignment s yields one set of
reduced potentials, stacked on a leading S axis; the reduced model's program
runs over (S, B) and the results aggregate with logsumexp:

    logZ[b]      = logsumexp_s( logZ_s[b] + logw_s[b] )
    P(v = x | e) ∝ logsumexp_s( logmarg_s[v, x] + logw_s[b] )
    P(c = x | e) ∝ logsumexp_{s : s_c = x}( logZ_s[b] + logw_s[b] )

where logw carries any evidence on the cutset variables themselves.
Everything runs in log space (per-state partition functions of big models
underflow linear float32), riding the log-matmul-exp contraction path for
any remaining big scopes.

The S axis is walked by a host loop over chunks; each chunk is one call of
the reduced program under ``torch.vmap``, and the logsumexp over S is
accumulated across chunks (``torch.logaddexp``), so no [S, B, K] tensor
exists whole.

Impossible evidence, on a reduced or on a cutset variable, gives zero
posteriors and logZ = -inf in every mode (masks go to log space unclamped).
MAP scores keep the tree-MAP program's contract: an infeasible row scores
below -1e29.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from .executor import (
    apply_masks,
    batched_propagate_program,
    evaluate_cliques_np,
    partition,
    propagate_cliques,
    resolve_device,
    var_marginals,
)
from .fused import (
    _TINY,
    build_fused_schedule,
    fused_posterior_program,
    stack_group_potentials,
)
from .labels import intern_factors
from .map_executor import tree_map_program
from .ops.semirings import LOG_SUM_EXP, SUM_PRODUCT
from .schedule import compile_plan
from .triangulate import min_fill_triangulation

_NEG = -1e30  # MAP masks: forbidden states that survive max-reductions


def _expnorm_safe(lp: torch.Tensor) -> torch.Tensor:
    """exp-normalize log scores along the last axis; rows where every score
    is impossible (non-finite logsumexp) return ZEROS instead of NaN: the
    same impossible-evidence contract as ``Engine.posterior_batch`` (zero
    posteriors, logZ = -inf)."""
    lse = torch.logsumexp(lp, dim=-1, keepdim=True)
    bad = ~torch.isfinite(lse)
    return torch.where(bad, 0.0, torch.exp(lp - torch.where(bad, 0.0, lse)))


def _single_query(plan, semiring, pots, masks):
    """One evidence row on unbatched potentials: (per-variable marginals,
    partition) in the semiring's space (the per-element form that
    ``torch.vmap`` batches)."""
    mpots = apply_masks(plan, pots, masks, semiring)
    beliefs, _ = propagate_cliques(plan, mpots, semiring)
    return var_marginals(plan, beliefs, semiring), partition(plan, beliefs, semiring)


def _lse_into(acc: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Running logsumexp over the cutset axis: ``x`` [chunk, ...] folded
    into ``acc`` [...]."""
    part = torch.logsumexp(x, dim=0)
    return part if acc is None else torch.logaddexp(acc, part)


def _max_states(factors, sizes, heuristic="min_fill") -> int:
    table, int_factors, int_sizes = intern_factors(factors, sizes)
    if not int_factors:
        return 0
    tri = min_fill_triangulation(int_factors, int_sizes, heuristic=heuristic)
    worst = 1
    for c in tri.maxcliques:
        states = 1
        for v in c:
            states *= int_sizes[v]
        worst = max(worst, states)
    return worst


def _without(factors, sizes, drop: set):
    """Reduced factor scopes with ``drop`` variables conditioned away.
    Scopes may become empty (per-assignment scalar weights)."""
    red = [[v for v in f if v not in drop] for f in factors]
    rsizes = {v: s for v, s in sizes.items() if v not in drop}
    return red, rsizes


def choose_cutset(
    factors,
    sizes,
    target_states: int = 1 << 16,
    max_vars: int = 6,
    max_enum: int = 4096,
) -> List[Hashable]:
    """Greedy loop cutset: repeatedly remove the variable that most shrinks
    the min-fill max-clique state space, until it is <= ``target_states``
    or the enumeration budget (prod of cutset cardinalities) is spent.

    Candidates are restricted to variables of the current largest clique
    (removing anything else cannot shrink it)."""
    cutset: List[Hashable] = []
    cur_factors, cur_sizes = [list(f) for f in factors], dict(sizes)
    enum = 1
    while len(cutset) < max_vars:
        table, int_factors, int_sizes = intern_factors(cur_factors, cur_sizes)
        if not int_factors:
            break
        tri = min_fill_triangulation(int_factors, int_sizes)
        worst_states, worst_clique = 0, None
        for c in tri.maxcliques:
            states = 1
            for v in c:
                states *= int_sizes[v]
            if states > worst_states:
                worst_states, worst_clique = states, c
        if worst_states <= target_states or worst_clique is None:
            break
        best_v, best_cost = None, None
        for v in worst_clique:
            label = table.label_of(v)
            if enum * cur_sizes[label] > max_enum:
                continue
            rf, rs = _without(cur_factors, cur_sizes, {label})
            cost = _max_states(rf, rs)
            if best_cost is None or cost < best_cost:
                best_v, best_cost = label, cost
        if best_v is None:
            break
        cutset.append(best_v)
        enum *= cur_sizes[best_v]
        cur_factors, cur_sizes = _without(cur_factors, cur_sizes, {best_v})
    return cutset


class CutsetEngine:
    """Exact inference by cutset conditioning (see module docstring).

    values are linear-space factor arrays.  Queries go through
    ``posterior_batch(mask_batch)`` with linear [B, size] masks for ANY
    variable, reduced or cutset; it returns ({label: [B, size] normalized
    posteriors} over every variable, logZ [B]) as tensors on ``device``
    (default CUDA device 0; ``"cpu"`` runs on the CPU) in ``dtype``
    (float32, or float64 for a reference run)."""

    def __init__(
        self,
        factors: Sequence[Sequence[Hashable]],
        sizes: Dict[Hashable, int],
        values: Sequence[np.ndarray],
        cutset: Optional[Sequence[Hashable]] = None,
        target_states: int = 1 << 16,
        max_enum: int = 4096,
        state_chunk: Optional[int] = None,
        chunk_budget_bytes: int = 8 << 30,
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        # None = auto-size per query batch: a chunk materializes
        # [chunk, B, clique_states] beliefs, so chunk is capped by the
        # memory budget (fixed chunks run out at large B on wide reduced
        # models)
        self._state_chunk = None if state_chunk is None else int(state_chunk)
        self._chunk_budget = int(chunk_budget_bytes)

        if cutset is None:
            cutset = choose_cutset(
                factors, sizes, target_states=target_states, max_enum=max_enum
            )
        self.cutset = list(cutset)
        cset = set(self.cutset)
        self.sizes = dict(sizes)
        self.factors = [list(f) for f in factors]

        # enumerate cutset assignments (row-major over self.cutset order)
        cards = [sizes[v] for v in self.cutset]
        S = int(np.prod(cards)) if cards else 1
        self.num_states = S
        grids = np.stack(
            [g.ravel() for g in np.meshgrid(
                *[np.arange(k) for k in cards], indexing="ij"
            )], axis=1,
        ) if cards else np.zeros((1, 0), dtype=int)
        self._assignments = grids  # [S, len(cutset)]

        # reduced model: factor scopes minus cutset vars; per-assignment
        # values by indexing the cutset axes.  Empty-scope factors fold into
        # the root clique as scalars (executor handles factor_to_maxclique
        # == -1), so they contribute the per-assignment weight exactly.
        red_factors, red_sizes = _without(self.factors, self.sizes, cset)
        self.plan = compile_plan(red_factors, red_sizes)

        # stack per-assignment clique potentials (log space): [S, *shape]
        self._values = [np.asarray(v, dtype=np.float64) for v in values]
        stacks: List[List[np.ndarray]] = None
        for s in range(S):
            vals = self._reduce_values(self._assignments[s])
            with np.errstate(divide="ignore"):
                vals = [np.log(v) for v in vals]
            pots = evaluate_cliques_np(self.plan, vals, LOG_SUM_EXP)
            if stacks is None:
                stacks = [[] for _ in pots]
            for i, p in enumerate(pots):
                stacks[i].append(p)
        self._pots = [self._place(np.stack(ps)) for ps in stacks]

        # one-hot state matrices for cutset-variable posteriors: [S, card]
        self._onehot = {}
        for j, v in enumerate(self.cutset):
            oh = np.full((S, sizes[v]), -np.inf)
            oh[np.arange(S), self._assignments[:, j]] = 0.0
            self._onehot[v] = self._place(oh)

        self._prog_cache: dict = {}
        self._fused_sched = None
        self._fused_pots = None

    def _place(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def _reduce_values(self, assign_row) -> List[np.ndarray]:
        """Per-assignment reduced factor values: cutset axes indexed at the
        assignment's states, other axes kept (linear space, float64)."""
        cset = set(self.cutset)
        out = []
        for f, val in zip(self.factors, self._values):
            idx = []
            for v in f:
                if v in cset:
                    idx.append(int(assign_row[self.cutset.index(v)]))
                else:
                    idx.append(slice(None))
            out.append(val[tuple(idx)])
        return out

    def describe(self) -> dict:
        st = self.plan.stats()
        st["cutset"] = list(self.cutset)
        st["cutset_states"] = self.num_states
        return st

    def _chunk_for(self, B: int, inner: str = "belief") -> int:
        """Cutset-axis chunk size of the host loop.  Auto mode caps what one
        chunk keeps at the memory budget.  Eager torch under ``torch.vmap``
        keeps every clique belief of the chunk, [chunk, B, clique_states]
        for each clique, beside the products it was made from: two such
        sets for the belief-form inner (measured on the card: 1.8, PERF.md),
        three for the message form (its messages and contraction
        intermediates)."""
        if self._state_chunk is not None:
            return max(1, min(self.num_states, self._state_chunk))
        st = self.plan.stats()
        states = max(1, st["total_clique_states"])
        live = 3 if inner == "message" else 2
        fit = self._chunk_budget // (4 * max(B, 1) * states * live)
        return max(1, min(self.num_states, int(fit), 256))

    def _fused_routing(self) -> bool:
        """Structural check: the reduced model's level groups collapse its
        op count (many small cliques, regular shapes).  NOT used for auto
        routing: cutset reduction destroys regularity on dense models
        (hailfinder-class: 42 groups for 43 cliques).  The fused path stays
        available via ``posterior_batch(mode='fused')``."""
        st = self.plan.stats()
        if st["num_cliques"] < 32 or st["max_clique_states"] > (1 << 13):
            return False
        n_groups = sum(len(gs) for gs in self._fused_schedule()[0].levels)
        return n_groups * 2 <= st["num_cliques"]

    def _fused_schedule(self):
        if self._fused_sched is None:
            self._fused_sched = build_fused_schedule(self.plan)
        return self._fused_sched

    def _fused_stacks(self):
        """[S, G, *shape] LINEAR-space prestacked group potentials (the
        fused program runs rescaled linear sum-product; per-clique factor
        products are O(1)-scaled, so linear storage is safe: the dynamic
        range builds up only inside propagation, where the fused program's
        per-message rescaling absorbs it)."""
        if self._fused_pots is None:
            sched = self._fused_schedule()[0]
            per_s = []
            for s in range(self.num_states):
                vals = self._reduce_values(self._assignments[s])
                pots = evaluate_cliques_np(self.plan, vals, SUM_PRODUCT)
                per_s.append(stack_group_potentials(sched, pots))
            self._fused_pots = [
                [
                    self._place(
                        np.stack([per_s[s][d][gi] for s in range(self.num_states)])
                    )
                    for gi in range(len(per_s[0][d]))
                ]
                for d in range(len(per_s[0]))
            ]
        return self._fused_pots

    def _batch_size(self, mask_batch) -> int:
        for m in mask_batch.values():
            return int(np.shape(m)[0])
        raise ValueError("need at least one evidence mask")

    def _log_weights(self, mask_batch, B: int, floor: Optional[float] = None):
        """Per-(s, b) cutset log-weights [S, B] from evidence on the cutset
        variables (forbidden states at ``floor``, or -inf)."""
        logw = torch.zeros((self.num_states, B), dtype=self.dtype,
                           device=self.device)
        for j, k in enumerate(self.cutset):
            if k not in mask_batch:
                continue
            lm = self._log_mask(mask_batch[k], floor)          # [B, card]
            sel = torch.as_tensor(self._assignments[:, j], device=self.device)
            logw = logw + lm[:, sel].T
        return logw

    def _log_mask(self, m, floor: Optional[float] = None) -> torch.Tensor:
        with np.errstate(divide="ignore"):
            lm = np.log(np.asarray(m, dtype=np.float64))
        return self._place(lm if floor is None else np.maximum(lm, floor))

    def _reduced_log_masks(self, mask_batch, B, floor: Optional[float] = None):
        """Log-space masks over ALL reduced variables (unobserved -> zeros):
        the per-element programs take a full per-var list."""
        plan = self.plan
        cset = set(self.cutset)
        by_id = {
            plan.table.id_of(k): v for k, v in mask_batch.items() if k not in cset
        }
        return [
            self._log_mask(by_id[v], floor) if v in by_id
            else torch.zeros((B, plan.sizes[v]), dtype=self.dtype,
                             device=self.device)
            for v in range(plan.num_vars)
        ]

    def _chunks(self, chunk: int):
        return [
            (s0, min(s0 + chunk, self.num_states))
            for s0 in range(0, self.num_states, chunk)
        ]

    def _aggregate(self, per_chunk, logw, chunk: int):
        """Walk the cutset axis in chunks.  ``per_chunk(s0, s1)`` returns
        (per-variable LOG marginals [chunk, B, K] without the weights,
        logZ_s [chunk, B]); the weighted logsumexp over S is accumulated
        across chunks.  Returns ({label: posterior}, logZ [B])."""
        plan = self.plan
        acc_v: List[Optional[torch.Tensor]] = [None] * plan.num_vars
        acc_c: List[Optional[torch.Tensor]] = [None] * len(self.cutset)
        logz = None
        for s0, s1 in self._chunks(chunk):
            margs, z = per_chunk(s0, s1)
            w = logw[s0:s1]
            z = z + w
            logz = _lse_into(logz, z)
            for v in range(plan.num_vars):
                acc_v[v] = _lse_into(acc_v[v], margs[v] + w[:, :, None])
            for j, k in enumerate(self.cutset):
                oh = self._onehot[k][s0:s1]                     # [chunk, card]
                acc_c[j] = _lse_into(acc_c[j], z[:, :, None] + oh[:, None, :])
        out = {
            plan.table.label_of(v): _expnorm_safe(acc_v[v])
            for v in range(plan.num_vars)
        }
        for k, m in zip(self.cutset, acc_c):
            out[k] = _expnorm_safe(m)
        return out, logz

    def _posterior_batch_fused(self, mask_batch: Dict[Hashable, np.ndarray]):
        """Stacked/fused cutset serving: the reduced model runs as ONE
        level-fused program (O(levels x groups) ops, ``fused.py``) under
        ``torch.vmap`` over cutset-assignment chunks, instead of O(reduced
        cliques) ops per chunk step.  Exact same aggregation math as the
        unrolled path; the per-assignment marginals come back normalized
        with a separate logZ_s, so log-space mixing is unchanged."""
        plan = self.plan
        cset = set(self.cutset)
        red_ids = tuple(sorted(
            plan.table.id_of(k) for k in mask_batch if k not in cset
        ))
        B = self._batch_size(mask_batch)
        logw = self._log_weights(mask_batch, B)
        masks = [self._place(mask_batch[plan.table.label_of(v)]) for v in red_ids]
        sched, sorted_children = self._fused_schedule()
        key = ("posterior_fused", red_ids)
        prog = self._prog_cache.get(key)
        if prog is None:
            prog = fused_posterior_program(
                sched, sorted_children, list(red_ids), device=self.device
            )
            self._prog_cache[key] = prog
        stacks = self._fused_stacks()
        clique_pos = sched.clique_pos
        cvars = plan.clique_vars

        def per_chunk(s0, s1):
            sub = [[g[s0:s1] for g in level] for level in stacks]
            marg, z = torch.vmap(lambda p: prog(p, masks))(sub)
            logm = []
            for v in range(plan.num_vars):
                c = plan.var_to_clique[v]
                d, gi, slot = clique_pos[c]
                m = marg[(d, gi, cvars[c].index(v))][:, :, slot]   # [chunk, B, K]
                m = m / m.sum(dim=-1, keepdim=True).clamp_min(_TINY)
                lp = torch.where(
                    m > 0, torch.log(m.clamp_min(_TINY)), -float("inf")
                )
                logm.append(lp + z[:, :, None])
            return logm, z

        return self._aggregate(per_chunk, logw, self._chunk_for(B))

    def posterior_batch(
        self, mask_batch: Dict[Hashable, np.ndarray], mode: str = "auto"
    ):
        """Batched posteriors + logZ over (S cutset assignments x B queries).

        mode: "auto" runs the per-clique belief-form program (one evidence
        row on one assignment's potentials, under ``torch.vmap`` over the
        rows and over a chunk of assignments); "message" forces the reduced
        model's batch-aware message program under ``torch.vmap`` over the
        chunk; "fused" forces the stacked level-fused reduced program
        (O(levels x groups) ops)."""
        if mode not in ("auto", "message", "fused"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "fused":
            return self._posterior_batch_fused(mask_batch)
        plan = self.plan
        B = self._batch_size(mask_batch)
        logmasks = self._reduced_log_masks(mask_batch, B)
        logw = self._log_weights(mask_batch, B)
        inner_mode = "message" if mode == "message" else "belief"
        inner = self._prog_cache.get(("posterior", inner_mode))
        if inner is None:
            if inner_mode == "message":
                inner = batched_propagate_program(plan, LOG_SUM_EXP)
            else:
                inner = torch.vmap(
                    lambda p, ms: _single_query(plan, LOG_SUM_EXP, p, ms),
                    in_dims=(None, 0),
                )
            self._prog_cache[("posterior", inner_mode)] = inner

        def per_chunk(s0, s1):
            sub = [p[s0:s1] for p in self._pots]
            return torch.vmap(lambda p: inner(p, logmasks))(sub)

        return self._aggregate(per_chunk, logw, self._chunk_for(B, inner_mode))

    def map_assignment_batch(self, mask_batch):
        """Exact batched MPE past the treewidth wall: per cutset assignment,
        the reduced model's max-product traceback (``map_executor``), then
        the best assignment over the cutset axis.

        MPE = max_s [ max_rest joint(rest | s) * w_s(evidence) ]: the max
        distributes over the conditioning exactly like the sum does for
        posteriors.  ``mask_batch``: {label: [B, size] LINEAR masks} for any
        variable (reduced or cutset).  Returns ({label: [B] int32 arrays
        over EVERY variable incl. the cutset}, scores [B] log unnormalized).

        The tree-MAP program writes its traceback in place, so the host loop
        takes the cutset assignments one by one and keeps the running best
        (the lowest assignment index among equals)."""
        plan = self.plan
        B = self._batch_size(mask_batch)
        logmasks = self._reduced_log_masks(mask_batch, B, _NEG)
        logw = self._log_weights(mask_batch, B, _NEG)
        prog = self._prog_cache.get(("map",))
        if prog is None:
            prog = tree_map_program(plan, list(range(plan.num_vars)))
            self._prog_cache[("map",)] = prog
        top = sel = best = None
        for s in range(self.num_states):
            # max-product wants log-space potentials: self._pots already are
            assign, score = prog([p[s] for p in self._pots], logmasks)
            score = score + logw[s]
            if top is None:
                top, sel = score, assign
                best = torch.zeros((B,), dtype=torch.int64, device=self.device)
                continue
            better = score > top
            top = torch.where(better, score, top)
            sel = torch.where(better[:, None], assign, sel)
            best = torch.where(better, s, best)
        sel = sel.cpu().numpy()
        best = best.cpu().numpy()
        out = {
            plan.table.label_of(v): sel[:, v].astype(np.int32)
            for v in range(plan.num_vars)
        }
        for j, k in enumerate(self.cutset):
            out[k] = self._assignments[best, j].astype(np.int32)
        return out, top.cpu().numpy()

    def map_assignment(self, evidence: Optional[Dict] = None):
        """Single MPE query with hard evidence {label: state}.  Returns
        ({label: state}, log unnormalized joint at the assignment)."""
        evidence = dict(evidence or {})
        masks = {}
        for k, state in evidence.items():
            m = np.zeros((1, self.sizes[k]), dtype=np.float32)
            m[0, int(state)] = 1.0
            masks[k] = m
        if not masks:  # need one mask to size the batch
            k0 = next(iter(self.sizes))
            masks[k0] = np.ones((1, self.sizes[k0]), dtype=np.float32)
        assign, score = self.map_assignment_batch(masks)
        return {k: int(v[0]) for k, v in assign.items()}, float(score[0])
