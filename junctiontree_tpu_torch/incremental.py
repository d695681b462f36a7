"""Incremental evidence serving: collect-message reuse across evidence deltas
(counterpart of ``junctiontree_tpu/incremental.py``).

The static schedule makes dirty-subtree tracking trivial host-side:

  * a session runs ONE full collect pass and caches every upward message
    (with its rescaling offset, so logZ stays exact);
  * an evidence delta on variable v dirties only the cliques on the path
    from v's clique to the root -- the delta program recomputes those
    messages (reusing cached ups of every off-path subtree) and then walks
    down only toward the requested query variables;
  * per delta the work is O(depth x clique) instead of O(n_cliques x
    clique) -- the serving win for single-variable updates ("what changes
    if this one observation flips").

PyTorch runs eagerly, so a "program" here is a closure over its static step
lists; the session caches one per (dirty-variable set, query-variable set).
Every contraction goes through the executor's routing ladder
(``executor.make_contract``): on a big clique that is the factored
big-clique contraction, the CUDA kernel on the card.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from .executor import _PROG_TINY as _TINY
from .executor import BATCH, cat_rows, clique_mask_vars, make_contract
from .ops.semirings import Semiring
from .schedule import Plan


def _rescale(out: torch.Tensor, batched: bool):
    """(message divided by its max, log of that max): per batch row when
    batched ([B] offsets), else one scalar."""
    if batched:
        s = out.reshape(out.shape[0], -1).amax(dim=1).clamp_min(_TINY)
        return out / s.reshape((-1,) + (1,) * (out.dim() - 1)), torch.log(s)
    s = out.max().clamp_min(_TINY)
    return out / s, torch.log(s)


def collect_program(plan: Plan, semiring: Semiring, observed: Sequence[int]):
    """Build ``fn(pots, masks) -> (ups, offs)`` plus the static batch flags.

    ``ups[c]`` is clique c's rescaled upward message to its parent separator
    (None at the root); ``offs[c]`` the log of its rescale factor.  Batch
    flags are static: a message is batched iff evidence reaches its subtree.
    """
    tree = plan.tree
    cvars = plan.clique_vars
    svars = plan.sep_vars
    observed = list(observed)
    mask_slot = {v: i for i, v in enumerate(observed)}
    cmv = clique_mask_vars(plan, observed)

    batched: List[bool] = [False] * tree.num_cliques
    for c in reversed(tree.topo_order):
        b = bool(cmv[c])
        for k, _ in tree.children[c]:
            b = b or batched[k]
        batched[c] = b

    contract = make_contract(plan, semiring)

    def fn(pots: Sequence[torch.Tensor], masks: Sequence[torch.Tensor]):
        ups: List[Optional[torch.Tensor]] = [None] * tree.num_cliques
        offs: List[Optional[torch.Tensor]] = [None] * tree.num_cliques
        for c in reversed(tree.topo_order):
            if c == tree.root:
                continue
            ops = [pots[c]]
            ovs: List[List[int]] = [list(cvars[c])]
            for v in cmv[c]:
                ops.append(masks[mask_slot[v]])
                ovs.append([BATCH, v])
            for k, s in tree.children[c]:
                ops.append(ups[k])
                ovs.append(([BATCH] if batched[k] else []) + list(svars[s]))
            out, b = contract(ops, ovs, svars[tree.parent_sep[c]])
            ups[c], offs[c] = _rescale(out, b)
        return ups, offs

    return fn, batched


def delta_program(
    plan: Plan,
    semiring: Semiring,
    observed: Sequence[int],
    base_batched: Sequence[bool],
    dirty_vars: Sequence[int],
    query_vars: Sequence[int],
):
    """Build ``fn(pots, base_masks, new_masks, ups, offs) ->
    (posteriors per query var [B, size], logZ [B])``.

    Only messages on the dirty-to-root paths are recomputed; downward
    messages are computed only along root-to-query paths."""
    tree = plan.tree
    cvars = plan.clique_vars
    svars = plan.sep_vars
    root = tree.root
    observed = list(observed)
    mask_slot = {v: i for i, v in enumerate(observed)}
    dirty_vars = list(dirty_vars)
    dirty_slot = {v: i for i, v in enumerate(dirty_vars)}
    all_vars = observed + [v for v in dirty_vars if v not in mask_slot]
    cmv = clique_mask_vars(plan, all_vars)

    # cliques whose upward message changes: dirty-to-root paths
    affected: set = set()
    for v in dirty_vars:
        c = plan.var_to_clique[v]
        while c != root and c not in affected:
            affected.add(c)
            c = tree.parent[c]
    recompute = [c for c in reversed(tree.topo_order) if c in affected]

    # static batch flags after the delta (new masks are always batched)
    upb: List[bool] = list(base_batched)
    for c in affected:
        upb[c] = True

    # downward walk: union of root-to-query-clique paths, parents first
    qclique = {v: plan.var_to_clique[v] for v in query_vars}
    contract = make_contract(plan, semiring)
    need_down: set = set()
    for c in set(qclique.values()):
        while c != root and c not in need_down:
            need_down.add(c)
            c = tree.parent[c]
    down_order = [c for c in tree.topo_order if c in need_down]

    def fn(pots, base_masks, new_masks, ups, offs):
        ups = list(ups)
        offs = list(offs)

        def mask_for(v):
            if v in dirty_slot:
                return new_masks[dirty_slot[v]]
            return base_masks[mask_slot[v]]

        def clique_ops(c):
            ops = [pots[c]]
            ovs: List[List[int]] = [list(cvars[c])]
            for v in cmv[c]:
                ops.append(mask_for(v))
                ovs.append([BATCH, v])
            return ops, ovs

        def up_operand(k, s):
            return ups[k], ([BATCH] if upb[k] else []) + list(svars[s])

        # -- recompute collect messages on the dirty paths --
        for c in recompute:
            ops, ovs = clique_ops(c)
            for k, s in tree.children[c]:
                o, v = up_operand(k, s)
                ops.append(o)
                ovs.append(v)
            out, b = contract(ops, ovs, svars[tree.parent_sep[c]])
            ups[c], offs[c] = _rescale(out, b)

        # -- logZ at the root (collect offsets make it exact) --
        rops, rovs = clique_ops(root)
        for k, s in tree.children[root]:
            o, v = up_operand(k, s)
            rops.append(o)
            rovs.append(v)
        z, _ = contract(rops, rovs, [])
        total_off = torch.zeros((), dtype=z.dtype, device=z.device)
        for c in range(tree.num_cliques):
            if c != root:
                total_off = total_off + offs[c]
        logz = torch.where(
            z > 0, torch.log(z.clamp_min(_TINY)),
            torch.full_like(z, -float("inf")),
        ) + total_off

        # -- downward messages along root-to-query paths only --
        down: Dict[int, torch.Tensor] = {}
        downv: Dict[int, List[int]] = {}
        for c in down_order:
            p = tree.parent[c]
            ops, ovs = clique_ops(p)
            if p != root:
                ops.append(down[p])
                ovs.append(downv[p])
            for k, s in tree.children[p]:
                if k != c:
                    o, v = up_operand(k, s)
                    ops.append(o)
                    ovs.append(v)
            out, b = contract(ops, ovs, svars[tree.parent_sep[c]])
            out, _ = _rescale(out, b)  # scale cancels in the normalization
            down[c] = out
            downv[c] = ([BATCH] if b else []) + list(svars[tree.parent_sep[c]])

        # -- query posteriors --
        B = int(new_masks[0].shape[0])
        if logz.dim() == 0:
            logz = logz.expand(B)
        posts: List[torch.Tensor] = []
        for v in query_vars:
            q = qclique[v]
            ops, ovs = clique_ops(q)
            if q != root:
                ops.append(down[q])
                ovs.append(downv[q])
            for k, s in tree.children[q]:
                o, vv = up_operand(k, s)
                ops.append(o)
                ovs.append(vv)
            m, b = contract(ops, ovs, [v])
            if not b:
                m = m[None, :].expand(B, m.shape[0])
            m = m / m.sum(dim=-1, keepdim=True).clamp_min(_TINY)
            posts.append(m)
        return posts, logz

    return fn


class IncrementalSession:
    """Cached-collect serving session (see module docstring).

    Create via ``Engine.incremental(mask_batch)``; query with
    ``session.query(updates, query_vars)`` where ``updates`` maps variable
    labels to [B, size] linear-space masks replacing that variable's base
    mask, and ``query_vars`` are the labels whose posteriors to return.
    ``rebase(updates)`` folds updates into the base (one fresh collect).

    The session computes in the engine's compute dtype (float32 on a
    bfloat16 engine) on the engine's device."""

    def __init__(self, engine, mask_batch, cached=None):
        if engine.semiring.name != "sum_product":
            raise ValueError(
                "incremental sessions require the sum_product semiring "
                "(rescaled linear messages)"
            )
        if engine._model_mesh is not None:
            raise ValueError(
                "incremental sessions do not support model-sharded engines"
            )
        self.engine = engine
        self.plan = engine.plan
        self._pots = engine._require_pots()
        ids, masks = engine._masks_to_program_args(mask_batch)
        self._ids = ids
        self._masks = masks
        self._B = int(masks[0].shape[0]) if masks else 1
        self._collect, self._batched = collect_program(
            self.plan, engine.semiring, list(ids)
        )
        # ``cached``: (ups, offs) of an earlier collect pass under this very
        # evidence (convert.session_from_numpy), instead of running one
        self._ups, self._offs = (
            self._collect(self._pots, masks) if cached is None else cached
        )
        self._delta_cache: Dict[tuple, object] = {}

    def _resolve(self, labels) -> Tuple[int, ...]:
        return tuple(self.plan.table.id_of(k) for k in labels)

    def query(self, updates: Dict[Hashable, torch.Tensor], query_vars):
        """Posteriors of ``query_vars`` + logZ under the base evidence with
        ``updates`` substituted.  The cached collect messages outside the
        dirty subtrees are reused; cost is O(path depth), not O(cliques)."""
        if not updates:
            raise ValueError("query() needs at least one updated mask")
        dirty = self._resolve(updates)
        qids = self._resolve(query_vars)
        new_masks = [self.engine._place(updates[k]) for k in updates]
        for v, m in zip(dirty, new_masks):
            if tuple(m.shape) != (self._B, self.plan.sizes[v]):
                raise ValueError(
                    "update mask for %r must be [%d, %d], got %r"
                    % (v, self._B, self.plan.sizes[v], tuple(m.shape))
                )
        key = (dirty, qids)
        fn = self._delta_cache.get(key)
        if fn is None:
            fn = delta_program(
                self.plan, self.engine.semiring, list(self._ids),
                self._batched, list(dirty), list(qids),
            )
            self._delta_cache[key] = fn
        return fn(self._pots, self._masks, new_masks, self._ups, self._offs)

    def rebase(self, updates: Dict[Hashable, torch.Tensor]) -> "IncrementalSession":
        """Fold ``updates`` into the base evidence and refresh the cached
        collect messages (one full collect pass)."""
        by_id = {self.plan.table.id_of(k): self.engine._place(v)
                 for k, v in updates.items()}
        masks = list(self._masks)
        ids = list(self._ids)
        for v, m in by_id.items():
            if v in ids:
                masks[ids.index(v)] = m
            else:
                raise KeyError(
                    "rebase variable %r is not part of the session's "
                    "observed set" % (v,)
                )
        self._masks = masks
        # drop the stale message cache BEFORE the fresh collect runs: the
        # old [B, sep_states] buffers would otherwise stay alive across the
        # call and double the session's peak memory on wide separators
        self._ups = self._offs = None
        self._ups, self._offs = self._collect(self._pots, masks)
        return self


class RowShardedSession:
    """The session of a ``shard_batch`` engine: one
    :class:`IncrementalSession` per device over its block of rows, with the
    same ``query`` and ``rebase``; results are concatenated along the rows
    on ``device``."""

    def __init__(self, sessions: Sequence[IncrementalSession], device):
        self.sessions = list(sessions)
        self.device = device
        self._rows, lo = [], 0
        for sess in self.sessions:
            self._rows.append(slice(lo, lo + sess._B))
            lo += sess._B

    def _cut(self, updates, rows):
        return {k: v[rows] for k, v in updates.items()}

    def query(self, updates: Dict[Hashable, torch.Tensor], query_vars):
        return cat_rows([sess.query(self._cut(updates, rows), query_vars)
                         for sess, rows in zip(self.sessions, self._rows)],
                        self.device)

    def rebase(self, updates: Dict[Hashable, torch.Tensor]) -> "RowShardedSession":
        for sess, rows in zip(self.sessions, self._rows):
            sess.rebase(self._cut(updates, rows))
        return self
