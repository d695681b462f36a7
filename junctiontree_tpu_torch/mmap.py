"""Exact Marginal MAP (MMAP), the fourth UAI query type
(counterpart of ``junctiontree_tpu/mmap.py``).

MMAP(Q) = argmax_{q over Q} sum_{S = other vars} prod_f f(...), the mixed
max/sum query that MAR (all-sum), PR (logZ) and MPE (all-max) bracket
(PR/MAR via ``executor.Engine``, MPE via ``map_executor``/``cutset``, MMAP
here).

MMAP is NP^PP-hard in general and, unlike MAR/MPE, is *not* computable on
an arbitrary junction tree: max and sum do not commute, so every SUM variable
must be eliminated before (deeper in the tree than) every MAX variable on its
root path.  The classic exact construction (Park & Darwiche 2004, bucket
elimination form per Dechter 1999):

  1. a *constrained* greedy min-fill elimination order eliminates all SUM
     variables first, then all MAX variables (host-side, pure Python);
  2. the bucket tree of that order (one cluster per variable, parent = the
     earliest-eliminated remaining neighbor) is valid by construction: every
     ancestor of a bucket eliminates a later variable, so MAX buckets only
     ever have MAX ancestors;
  3. the collect pass is one static sequence of torch operations over an
     evidence-mask batch: log-space potentials, logsumexp-reduction at SUM
     buckets, max-reduction + argmax backpointers at MAX buckets; a bucket
     that no evidence reaches keeps a batch axis of 1;
  4. a downward traceback decodes a *consistent* joint argmax of the MAX
     variables per batch element (tie-safe by construction, exactly like
     ``map_executor.tree_map_program``).

The constrained order can have (sometimes dramatically) larger induced width
than the free order; that is intrinsic to exact MMAP, not an implementation
artifact.  ``MarginalMapSolver`` raises with the offending bucket size when
the constrained width is infeasible.

An infeasible row (evidence the model gives probability zero) scores about
-1e30, as in the tree-MAP program: "score < -1e29" means no feasible
assignment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .executor import resolve_device
from .labels import intern_factors
from .triangulate import build_adjacency, _fill_count, _weight

_NEG = -1e30  # -inf stand-in that survives max-reductions without NaNs


def constrained_order(
    factors: Sequence[Sequence[int]],
    sizes: Sequence[int],
    late: Set[int],
    heuristic: str = "min_fill",
) -> List[int]:
    """Greedy elimination order eliminating every var NOT in ``late``
    before any var in ``late``.  ``min_fill`` scores (fill, weight, id) —
    the same criterion as the free min_fill_triangulation; ``min_degree``
    and ``min_weight`` reorder the keys (same portfolio as triangulate.py,
    here under the two-phase constraint)."""
    if heuristic == "min_fill":
        keyf = lambda adj, v: (_fill_count(adj, v), _weight(adj, sizes, v), v)
    elif heuristic == "min_degree":
        keyf = lambda adj, v: (len(adj[v]), _weight(adj, sizes, v), v)
    elif heuristic == "min_weight":
        keyf = lambda adj, v: (_weight(adj, sizes, v), _fill_count(adj, v), v)
    else:
        raise ValueError(f"unknown constrained heuristic {heuristic!r}")
    num_vars = len(sizes)
    adj = build_adjacency(factors, num_vars)
    remaining: Set[int] = set(range(num_vars))
    order: List[int] = []
    while remaining:
        cands = [v for v in remaining if v not in late]
        if not cands:
            cands = list(remaining)
        best = min(cands, key=lambda v: keyf(adj, v))
        nbrs = [u for u in adj[best] if u in remaining]
        for i, u in enumerate(nbrs):
            for w in nbrs[i + 1:]:
                if w not in adj[u]:
                    adj[u].add(w)
                    adj[w].add(u)
        for u in nbrs:
            adj[u].discard(best)
        remaining.discard(best)
        order.append(best)
    return order


@dataclass(frozen=True)
class BucketTree:
    """Bucket-elimination tree: one cluster per variable.

    ``scope[v]`` is the sorted cluster at v's elimination (v plus its
    then-remaining neighbors); ``parent[v]`` is the earliest-eliminated
    variable of ``scope[v] - {v}`` (-1 for roots); ``factor_bucket[f]`` is
    the bucket (variable id) owning factor f = the earliest-eliminated
    variable in its scope (-1 for empty-scope factors)."""

    order: List[int]
    scope: Dict[int, List[int]]
    parent: Dict[int, int]
    factor_bucket: List[int]

    def max_bucket_states(self, sizes: Sequence[int]) -> int:
        best = 1
        for sc in self.scope.values():
            w = 1
            for v in sc:
                w *= sizes[v]
            best = max(best, w)
        return best


def build_bucket_tree(
    factors: Sequence[Sequence[int]],
    sizes: Sequence[int],
    order: Sequence[int],
) -> BucketTree:
    """Bucket tree of eliminating in the GIVEN order.

    RIP holds by the standard elimination-tree argument: when v is
    eliminated its remaining neighbors form a clique (fill edges), so the
    message scope ``scope[v] - {v}`` is contained in the parent's cluster.
    """
    num_vars = len(sizes)
    adj = build_adjacency(factors, num_vars)
    pos = {v: i for i, v in enumerate(order)}
    if len(pos) != num_vars:
        raise ValueError("order must eliminate every variable exactly once")
    remaining: Set[int] = set(range(num_vars))
    scope: Dict[int, List[int]] = {}
    parent: Dict[int, int] = {}
    for best in order:
        nbrs = [u for u in adj[best] if u in remaining]
        scope[best] = sorted(nbrs + [best])
        parent[best] = min(nbrs, key=lambda u: pos[u]) if nbrs else -1
        for i, u in enumerate(nbrs):
            for w in nbrs[i + 1:]:
                adj[u].add(w)
                adj[w].add(u)
        for u in nbrs:
            adj[u].discard(best)
        remaining.discard(best)
    factor_bucket = [
        (min(f, key=lambda v: pos[v]) if len(f) else -1) for f in factors
    ]
    return BucketTree(
        order=list(order), scope=scope, parent=parent,
        factor_bucket=factor_bucket,
    )


def _strides(shape: Sequence[int]) -> List[int]:
    st = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        st[i] = st[i + 1] * shape[i + 1]
    return st


def mmap_program(
    bt: BucketTree,
    factors: Sequence[Sequence[int]],
    sizes: Sequence[int],
    max_ids: Sequence[int],
    observed: Sequence[int],
):
    """Build ``fn(log_factors, masks) -> (assign [B, len(max_ids)] int32,
    score [B])``.

    log_factors: unbatched log-space per-factor tensors (factor scopes as
    given).  masks: list aligned with ``observed`` (var ids), each
    [B, size_v] in LOG space (0 = allowed, very negative = forbidden).
    score is log( max_{max_ids} sum_{rest} prod_f f * masks ), the exact
    MMAP value, achieved by the returned assignment.  Empty-scope factors
    contribute a scalar log-offset."""
    max_set = set(max_ids)
    order = bt.order
    observed = list(observed)
    mask_slot = {v: i for i, v in enumerate(observed)}
    children: Dict[int, List[int]] = {v: [] for v in order}
    for v in order:
        p = bt.parent[v]
        if p >= 0:
            children[p].append(v)
    bucket_factors: Dict[int, List[int]] = {v: [] for v in order}
    scalar_factors: List[int] = []
    for f, b in enumerate(bt.factor_bucket):
        if b < 0:
            scalar_factors.append(f)
        else:
            bucket_factors[b].append(f)
    max_cols = {v: i for i, v in enumerate(max_ids)}

    def fn(log_factors, masks):
        B = int(masks[0].shape[0]) if masks else 1
        dtype, device = log_factors[0].dtype, log_factors[0].device
        msgs: Dict[int, torch.Tensor] = {}   # v -> [B or 1, *sep_shape]
        bps: Dict[int, torch.Tensor] = {}    # max v -> [B or 1, sepN] int32
        score = torch.zeros((B,), dtype=dtype, device=device)
        for v in order:
            sc = bt.scope[v]
            shape = tuple(sizes[u] for u in sc)
            ax_of = {u: i for i, u in enumerate(sc)}

            def placed(t, tvars, lead):
                """``t`` ([lead, *tvars]) broadcastable to [B, *shape]."""
                perm = sorted(range(len(tvars)), key=lambda i: ax_of[tvars[i]])
                expand = [lead] + [1] * len(shape)
                for u in tvars:
                    expand[1 + ax_of[u]] = sizes[u]
                return t.permute([0] + [1 + i for i in perm]).reshape(expand)

            terms = [
                placed(log_factors[f][None], list(factors[f]), 1)
                for f in bucket_factors[v]
            ]
            if v in mask_slot:
                m = masks[mask_slot[v]].to(dtype).clamp_min(_NEG)
                terms.append(placed(m, [v], B))
            for c in children[v]:
                csep = [u for u in bt.scope[c] if u != c]
                m = msgs.pop(c)  # [B or 1, *sep_shape] in csep (sorted) order
                terms.append(placed(m, csep, int(m.shape[0])))
            # the sum of the terms in their order; the batch axis appears
            # with the first batched term
            bel = torch.zeros((1,) + shape, dtype=dtype, device=device)
            for t in terms:
                bel = bel + t
            lead = int(bel.shape[0])
            # reduce out v: logsumexp for SUM vars, max (+ backpointer
            # conditioned on the separator assignment) for MAX vars
            sep = [u for u in sc if u != v]
            sep_shape = tuple(sizes[u] for u in sep)
            sepN = int(np.prod(sep_shape)) if sep else 1
            # move v's axis last, flatten the separator
            perm = [0] + [1 + ax_of[u] for u in sep] + [1 + ax_of[v]]
            p2 = bel.permute(perm).reshape(lead, sepN, sizes[v])
            if v in max_set:
                red, arg = p2.max(dim=-1)                   # [lead, sepN]
                bps[v] = arg.to(torch.int32)
            else:
                red = torch.logsumexp(p2, dim=-1)           # [lead, sepN]
            if sep:
                msgs[v] = red.reshape((lead,) + sep_shape)
            else:
                score = score + red.reshape((lead,))
        for f in scalar_factors:
            score = score + log_factors[f].reshape(()).to(dtype)

        # traceback: roots first; a MAX bucket's separator holds only
        # later-eliminated (hence MAX, hence already-decoded) variables
        assign = torch.zeros((B, len(max_ids)), dtype=torch.int32, device=device)
        for v in reversed(order):
            if v not in max_set:
                continue
            sep = [u for u in bt.scope[v] if u != v]
            sep_flat = torch.zeros((B,), dtype=torch.int64, device=device)
            for u in sep:
                sep_flat = sep_flat * sizes[u] + assign[:, max_cols[u]]
            bp = bps[v]
            assign[:, max_cols[v]] = (
                bp[0][sep_flat] if bp.shape[0] == 1
                else torch.take_along_dim(bp, sep_flat[:, None], dim=1)[:, 0]
            )
        return assign, score

    return fn


class MarginalMapSolver:
    """Exact batched Marginal-MAP queries on a discrete factor graph.

    Built once per (model, MAP-variable set); every evidence instantiation
    is then a masked query through one static program (same static-shape
    mask discipline as executor.Engine), on ``device`` (default CUDA device
    0; ``"cpu"`` runs on the CPU) in ``dtype`` (float32, or float64 for a
    reference run).

        solver = MarginalMapSolver(factors, sizes, map_vars=["a", "d"])
        solver.set_potentials(values)
        assignment, log_score = solver.query({"b": 1})
        assigns, scores = solver.query_batch({"b": mask_B_x_size})

    ``map_vars`` ordering is preserved in the batched assignment columns
    (``solver.map_vars``).
    """

    def __init__(
        self,
        factors: Sequence[Sequence[Hashable]],
        sizes: Dict[Hashable, int],
        map_vars: Sequence[Hashable],
        max_states: int = 1 << 28,
        device=None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        self.device = resolve_device(device)
        self.dtype = dtype
        self.table, self._factors, self._sizes = intern_factors(factors, sizes)
        self.map_vars: List[Hashable] = list(map_vars)
        if len(set(self.map_vars)) != len(self.map_vars):
            raise ValueError("map_vars contains duplicates")
        # intern_factors only interns variables used by some factor; a free
        # MAP variable would otherwise surface as an opaque KeyError deep in
        # LabelTable: validate up front with a useful message.
        unknown = [x for x in self.map_vars if x not in self.table]
        if unknown:
            raise ValueError(
                f"map_vars {unknown!r} appear in no factor; a variable "
                f"unconstrained by the model has no posterior to maximize "
                f"(drop it, or add a unary factor over it)"
            )
        self._max_ids = [self.table.id_of(x) for x in self.map_vars]
        # portfolio over constrained heuristics: the two-phase constraint
        # changes which greedy criterion wins per graph, and feasibility
        # hangs on the induced width (same rationale as the free-order
        # portfolio in triangulate.portfolio_triangulation)
        # Feasibility dominates total cost: a candidate whose
        # largest bucket fits under max_states must beat a lower-total
        # candidate that exceeds the cap, else we raise 'infeasible'
        # spuriously.  Key = (over_cap?, total_states).
        best_bt, best_key = None, None
        for h in ("min_fill", "min_degree", "min_weight"):
            order = constrained_order(
                self._factors, self._sizes, set(self._max_ids), heuristic=h
            )
            bt = build_bucket_tree(self._factors, self._sizes, order)
            cost = sum(
                int(np.prod([self._sizes[v] for v in sc]))
                for sc in bt.scope.values()
            )
            key = (bt.max_bucket_states(self._sizes) > max_states, cost)
            if best_key is None or key < best_key:
                best_bt, best_key = bt, key
        self.bt = best_bt
        worst = self.bt.max_bucket_states(self._sizes)
        if worst > max_states:
            raise ValueError(
                f"constrained (sum-before-max) elimination yields a "
                f"{worst:,}-state bucket (cap {max_states:,}); exact MMAP "
                f"on this MAP-variable set is infeasible — shrink map_vars "
                f"or condition on a cutset first"
            )
        self._log_pots = None
        self._fn_cache: Dict[tuple, object] = {}

    @property
    def constrained_width(self) -> int:
        """Induced width of the constrained order (bucket size - 1)."""
        return max(len(s) for s in self.bt.scope.values()) - 1

    def describe(self) -> dict:
        """Compile stats (observability parity with Engine.describe)."""
        total = sum(
            int(np.prod([self._sizes[v] for v in sc]))
            for sc in self.bt.scope.values()
        )
        return {
            "num_vars": len(self._sizes),
            "num_map_vars": len(self._max_ids),
            "num_buckets": len(self.bt.scope),
            "constrained_width": self.constrained_width,
            "max_bucket_states": self.bt.max_bucket_states(self._sizes),
            "total_bucket_states": total,
            "compiled_programs": len(self._fn_cache),
        }

    def set_potentials(self, values: Sequence[np.ndarray]) -> "MarginalMapSolver":
        """Per-factor potential arrays (linear space, aligned with the
        constructor's factor list).  Zeros become -1e30 in log space (the
        same structural-zero discipline as the max-product engines)."""
        if len(values) != len(self._factors):
            raise ValueError(
                f"expected {len(self._factors)} potential arrays, got {len(values)}"
            )
        logs = []
        for f, val in zip(self._factors, values):
            a = np.asarray(val, dtype=np.float64)
            want = tuple(self._sizes[v] for v in f)
            if a.shape != want:
                raise ValueError(
                    f"potential for factor {f} has shape {a.shape}, want {want}"
                )
            with np.errstate(divide="ignore"):
                la = np.where(a > 0.0, np.log(np.maximum(a, 1e-300)), _NEG)
            logs.append(la)
        self._log_pots = [
            torch.as_tensor(x, dtype=self.dtype, device=self.device)
            for x in logs
        ]
        return self

    def _program(self, ids: Tuple[int, ...]):
        fn = self._fn_cache.get(ids)
        if fn is None:
            fn = mmap_program(
                self.bt, self._factors, self._sizes, self._max_ids, list(ids)
            )
            self._fn_cache[ids] = fn
        return fn

    def query_batch(self, mask_batch: Dict[Hashable, np.ndarray]):
        """Batched MMAP: ``mask_batch`` maps var label (or id) to a
        [B, size_v] LOG-space mask (0 = allowed).  Returns device tensors
        (assignments [B, len(map_vars)] int32, scores [B])."""
        if self._log_pots is None:
            raise ValueError("set_potentials() before querying")
        logmasks = {
            (k if isinstance(k, int) else self.table.id_of(k)): torch.as_tensor(
                np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                dtype=self.dtype, device=self.device,
            )
            for k, v in mask_batch.items()
        }
        if not logmasks:
            logmasks[0] = torch.zeros(
                (1, self._sizes[0]), dtype=self.dtype, device=self.device
            )
        ids = tuple(sorted(logmasks))
        fn = self._program(ids)
        return fn(self._log_pots, [logmasks[v] for v in ids])

    def query(
        self, evidence: Optional[Dict[Hashable, int]] = None
    ) -> Tuple[Dict[Hashable, int], float]:
        """Single MMAP query with hard evidence {var label: state}.

        Returns ({map var label: state}, log of the MMAP value) — the
        maximal sum over non-MAP variables of the unnormalized joint
        consistent with the evidence."""
        masks = {}
        for label, state in (evidence or {}).items():
            v = self.table.id_of(label)
            mk = np.full((1, self._sizes[v]), _NEG, dtype=np.float32)
            mk[0, int(state)] = 0.0
            masks[v] = mk
        assign, score = self.query_batch(masks)
        assign = assign.cpu().numpy()
        out = {lab: int(assign[0, i]) for i, lab in enumerate(self.map_vars)}
        return out, float(score[0])


def marginal_map(
    factors: Sequence[Sequence[Hashable]],
    values: Sequence[np.ndarray],
    sizes: Dict[Hashable, int],
    map_vars: Sequence[Hashable],
    evidence: Optional[Dict[Hashable, int]] = None,
    device=None,
) -> Tuple[Dict[Hashable, int], float]:
    """One-shot exact Marginal MAP (see MarginalMapSolver for serving)."""
    return (
        MarginalMapSolver(factors, sizes, map_vars, device=device)
        .set_potentials(values)
        .query(evidence)
    )
