"""Level-fused executor: grouped static schedule (counterpart of
``junctiontree_tpu/fused.py``).

The general program runs O(num_cliques) contractions; on regular graphs
most cliques at a tree level share an identical contraction signature
(shape, separator axes, children layout).  This executor groups them: each
group's potentials are prestacked into one [G, *shape] tensor and the whole
group's messages are computed by single batched operations, so a step is
O(levels x groups) device operations, which is what an eagerly run program
on many small cliques pays for.

Evidence masks are written into per-(group, axis) multiplier tensors by
index; cross-level message routing concatenates the source tensors of one
separator shape and gathers with an index tensor.  Both kinds of index
tensor are built once per program, on the device it runs on.  Rescaled
linear sum-product only; outputs are a lazy per-variable marginal view +
logZ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .schedule import Plan

_TINY = 1e-38


@dataclass
class Group:
    """Cliques sharing one contraction signature at one level."""

    cliques: List[int]
    shape: Tuple[int, ...]
    # axes (positions into shape) of the separator to the parent; None at root
    parent_axes: Optional[Tuple[int, ...]]
    # per child position: axes of that child's separator in this clique
    child_axes: List[Tuple[int, ...]]

    @property
    def G(self) -> int:
        return len(self.cliques)

    def sep_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.parent_axes)

    def child_sep_shape(self, k: int) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.child_axes[k])


@dataclass
class FusedSchedule:
    plan: Plan
    levels: List[List[Group]]                 # levels[0] = [root group(s)]
    clique_pos: Dict[int, Tuple[int, int, int]]  # clique -> (level, group ix, slot)
    # var id -> (level, group ix, slot, axis) where its mask lands
    mask_site: Dict[int, Tuple[int, int, int, int]]


def build_fused_schedule(
    plan: Plan,
) -> Tuple[FusedSchedule, Dict[int, List[Tuple[int, int]]]]:
    """Group the cliques of each tree level by contraction signature.
    Returns (schedule, children of each clique in the sorted-axes order the
    groups' ``child_axes`` use)."""
    tree = plan.tree
    cvars = plan.clique_vars
    svars = plan.sep_vars

    depth = {tree.root: 0}
    for c in tree.topo_order[1:]:
        depth[c] = depth[tree.parent[c]] + 1
    max_d = max(depth.values())

    # canonical per-clique signature
    def child_axes_of(c: int) -> List[Tuple[int, ...]]:
        axes = []
        for k, s in tree.children[c]:
            axes.append(tuple(cvars[c].index(v) for v in svars[s]))
        axes.sort()
        return axes

    # children must be traversed in the sorted-axes order used above
    sorted_children: Dict[int, List[Tuple[int, int]]] = {}
    for c in range(tree.num_cliques):
        kids = list(tree.children[c])
        kids.sort(
            key=lambda ks: tuple(cvars[c].index(v) for v in svars[ks[1]])
        )
        sorted_children[c] = kids

    levels: List[List[Group]] = []
    clique_pos: Dict[int, Tuple[int, int, int]] = {}
    for d in range(max_d + 1):
        sig_map: Dict[tuple, Group] = {}
        order: List[tuple] = []
        for c in tree.topo_order:
            if depth[c] != d:
                continue
            shape = tuple(plan.sizes[v] for v in cvars[c])
            paxes = (
                None
                if c == tree.root
                else tuple(
                    cvars[c].index(v)
                    for v in svars[tree.parent_sep[c]]
                )
            )
            caxes = child_axes_of(c)
            sig = (shape, paxes, tuple(caxes))
            g = sig_map.get(sig)
            if g is None:
                g = Group(
                    cliques=[], shape=shape, parent_axes=paxes,
                    child_axes=caxes,
                )
                sig_map[sig] = g
                order.append(sig)
            g.cliques.append(c)
        groups = [sig_map[s] for s in order]
        for gi, g in enumerate(groups):
            for slot, c in enumerate(g.cliques):
                clique_pos[c] = (d, gi, slot)
        levels.append(groups)

    mask_site: Dict[int, Tuple[int, int, int, int]] = {}
    for v in range(plan.num_vars):
        c = plan.var_to_clique[v]
        d, gi, slot = clique_pos[c]
        axis = cvars[c].index(v)
        mask_site[v] = (d, gi, slot, axis)

    return FusedSchedule(
        plan=plan, levels=levels, clique_pos=clique_pos, mask_site=mask_site
    ), sorted_children


def stack_group_potentials(
    sched: FusedSchedule, pots_np: Sequence[np.ndarray]
) -> List[List[np.ndarray]]:
    """Host-side prestack: per level, per group, [G, *shape] float arrays."""
    out: List[List[np.ndarray]] = []
    for groups in sched.levels:
        out.append(
            [np.stack([pots_np[c] for c in g.cliques]) for g in groups]
        )
    return out


def _bcast_into(msg, msg_axes, shape):
    """[B, G, *sep] -> [B, G, *shape] broadcastable view (non-sep axes
    become 1); ``msg``'s axes are ordered as ``msg_axes``, which increase."""
    new = [msg.shape[0], msg.shape[1]] + [1] * len(shape)
    for i, a in enumerate(msg_axes):
        new[2 + a] = msg.shape[2 + i]
    return msg.reshape(new)


class _Gather:
    """Static routing of messages between levels: slot ``j`` of the result
    is slot ``slot_j`` of source tensor ``key_j``.  The distinct sources are
    concatenated along the group axis and gathered with one index tensor
    (one source whose slots are taken in order is passed through)."""

    def __init__(self, sources: Sequence[Tuple[tuple, int]], sizes, device):
        self.keys: List[tuple] = []
        for key, _ in sources:
            if key not in self.keys:
                self.keys.append(key)
        offset, at = {}, 0
        for key in self.keys:
            offset[key] = at
            at += sizes[key]
        index = [offset[key] + slot for key, slot in sources]
        self.identity = index == list(range(at))
        self.index = torch.tensor(index, dtype=torch.long, device=device)

    def __call__(self, tensors: Dict[tuple, torch.Tensor]) -> torch.Tensor:
        parts = [tensors[k] for k in self.keys]
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return x if self.identity else x.index_select(1, self.index)


def _rescale(m: torch.Tensor):
    """Divide each [*sep] message of m [B, G, *sep] by its max; returns the
    message and the maxima [B, G]."""
    s = m.reshape(m.shape[0], m.shape[1], -1).amax(dim=-1).clamp_min(_TINY)
    return m / s.reshape(s.shape + (1,) * (m.dim() - 2)), s


def _reduce_to(acc: torch.Tensor, shape, axes) -> torch.Tensor:
    """Sum acc [B, G, *shape] down to [B, G, *axes], axes in ``axes``
    order."""
    red = [2 + a for a in range(len(shape)) if a not in axes]
    m = acc.sum(dim=red) if red else acc
    kept = sorted(axes)
    return m.permute([0, 1] + [2 + kept.index(a) for a in axes])


def fused_posterior_program(
    sched: FusedSchedule,
    sorted_children: Dict[int, List[Tuple[int, int]]],
    observed: Sequence[int],
    device=None,
):
    """Build ``fn(stacked_pots, masks) -> (marginal tensors, logZ [B])``.

    stacked_pots: nested lists matching sched.levels ([G, *shape] each), on
    ``device``.  masks: list of [B, size_v] linear-space tensors aligned
    with ``observed``.  Returns per-(level, group, axis) marginal tensors
    [B, G, size] in a dict plus logZ; wrap with FusedPosteriors for per-var
    access."""
    plan = sched.plan
    tree = plan.tree
    levels = sched.levels
    observed = list(observed)
    mask_slot = {v: i for i, v in enumerate(observed)}
    group_size = {
        (d, gi): g.G for d, groups in enumerate(levels)
        for gi, g in enumerate(groups)
    }

    # routing, built once ----------------------------------------------------
    # up_gather[(d, gi, k)]: the collect messages of the k-th children of
    # group (d, gi)'s cliques, from the groups of level d+1
    up_gather: Dict[Tuple[int, int, int], _Gather] = {}
    for d, groups in enumerate(levels):
        for gi, g in enumerate(groups):
            for k in range(len(g.child_axes)):
                src = []
                for c in g.cliques:
                    child_c, _ = sorted_children[c][k]
                    _, cgi, cslot = sched.clique_pos[child_c]
                    src.append(((d + 1, cgi), cslot))
                up_gather[(d, gi, k)] = _Gather(src, group_size, device)
    # down_gather[(d, cgi)]: the distribute messages into group (d, cgi),
    # from the staged outputs (parent group, child position) of level d-1
    down_gather: Dict[Tuple[int, int], _Gather] = {}
    for d in range(1, len(levels)):
        staged_size = {
            (pgi, k): pg.G for pgi, pg in enumerate(levels[d - 1])
            for k in range(len(pg.child_axes))
        }
        for cgi, cg in enumerate(levels[d]):
            src = []
            for c in cg.cliques:
                p = tree.parent[c]
                _, pgi, pslot = sched.clique_pos[p]
                k = next(
                    i for i, (kc, _) in enumerate(sorted_children[p]) if kc == c
                )
                src.append(((pgi, k), pslot))
            down_gather[(d, cgi)] = _Gather(src, staged_size, device)
    # masks per (level, group, axis): slots (index tensor) and mask positions
    sites: Dict[Tuple[int, int, int], List[Tuple[int, int]]] = {}
    for v in observed:
        d, gi, slot, axis = sched.mask_site[v]
        sites.setdefault((d, gi, axis), []).append((slot, mask_slot[v]))
    mask_sites = {
        key: (
            torch.tensor([s for s, _ in lst], dtype=torch.long, device=device),
            [i for _, i in lst],
        )
        for key, lst in sites.items()
    }

    def fn(stacked_pots, masks):
        B = masks[0].shape[0] if masks else 1
        dtype = stacked_pots[0][0].dtype
        memo: Dict[Tuple[int, int], torch.Tensor] = {}

        def masked_pot(d, gi):
            """[B, G, *shape]: the group's potentials times its masks (a
            view of the potentials where the group has no mask)."""
            if (d, gi) in memo:
                return memo[(d, gi)]
            g = levels[d][gi]
            acc = stacked_pots[d][gi][None]  # [1, G, *shape]
            for axis in range(len(g.shape)):
                site = mask_sites.get((d, gi, axis))
                if site is None:
                    continue
                slots, which = site
                M = torch.ones(
                    (B, g.G, g.shape[axis]), dtype=dtype, device=acc.device
                )
                M.index_copy_(
                    1, slots,
                    torch.stack([masks[i].to(dtype) for i in which], dim=1),
                )
                acc = acc * _bcast_into(M, (axis,), g.shape)
            # keep every tensor batched so cross-group gathers are uniform
            if acc.shape[0] != B:
                return acc.expand((B,) + tuple(acc.shape[1:]))
            memo[(d, gi)] = acc
            return acc

        # ---- collect (deepest level first): up[(d, gi)] = [B, G, *sep] ----
        up: Dict[Tuple[int, int], torch.Tensor] = {}
        logoff = torch.zeros((B,), dtype=dtype, device=stacked_pots[0][0].device)
        for d in range(len(levels) - 1, 0, -1):
            for gi, g in enumerate(levels[d]):
                acc = masked_pot(d, gi)
                for k, caxes in enumerate(g.child_axes):
                    acc = acc * _bcast_into(
                        up_gather[(d, gi, k)](up), caxes, g.shape
                    )
                m, s = _rescale(_reduce_to(acc, g.shape, g.parent_axes))
                logoff = logoff + torch.log(s).sum(dim=1)
                up[(d, gi)] = m

        # ---- distribute: down[(d, gi)] = [B, G, *sep] from the parents ----
        down: Dict[Tuple[int, int], torch.Tensor] = {}
        for d in range(0, len(levels) - 1):
            # messages to the k-th children of every group at level d
            staged: Dict[Tuple[int, int], torch.Tensor] = {}
            for gi, g in enumerate(levels[d]):
                K = len(g.child_axes)
                if K == 0:
                    continue
                base = masked_pot(d, gi)
                if g.parent_axes is not None:
                    base = base * _bcast_into(
                        down[(d, gi)], g.parent_axes, g.shape
                    )
                bcasts = [
                    _bcast_into(up_gather[(d, gi, k)](up), caxes, g.shape)
                    for k, caxes in enumerate(g.child_axes)
                ]
                prefix = [None] * K
                suffix = [None] * K
                run = None
                for i in range(K):
                    prefix[i] = run
                    run = bcasts[i] if run is None else run * bcasts[i]
                run = None
                for i in range(K - 1, -1, -1):
                    suffix[i] = run
                    run = bcasts[i] if run is None else run * bcasts[i]
                for k, caxes in enumerate(g.child_axes):
                    loo = base
                    if prefix[k] is not None:
                        loo = loo * prefix[k]
                    if suffix[k] is not None:
                        loo = loo * suffix[k]
                    staged[(gi, k)], _ = _rescale(
                        _reduce_to(loo, g.shape, caxes)
                    )
            for cgi in range(len(levels[d + 1])):
                down[(d + 1, cgi)] = down_gather[(d + 1, cgi)](staged)

        # ---- beliefs + per-(group, axis) marginals + logZ ----
        marg: Dict[Tuple[int, int, int], torch.Tensor] = {}
        logz = None
        for d, groups in enumerate(levels):
            for gi, g in enumerate(groups):
                acc = masked_pot(d, gi)
                if g.parent_axes is not None:
                    acc = acc * _bcast_into(
                        down[(d, gi)], g.parent_axes, g.shape
                    )
                for k, caxes in enumerate(g.child_axes):
                    acc = acc * _bcast_into(
                        up_gather[(d, gi, k)](up), caxes, g.shape
                    )
                for axis in range(len(g.shape)):
                    marg[(d, gi, axis)] = _reduce_to(acc, g.shape, (axis,))
                if tree.root in g.cliques:
                    slot = g.cliques.index(tree.root)
                    z = acc[:, slot].reshape(B, -1).sum(dim=-1)
                    logz = torch.where(
                        z > 0, torch.log(z.clamp_min(_TINY)),
                        torch.full_like(z, -float("inf")),
                    ) + logoff
        return marg, logz

    return fn


class FusedPosteriors:
    """Lazy per-var-id view over per-(level, group, axis) marginal tensors,
    normalized on access."""

    def __init__(self, sched: FusedSchedule, marg: dict):
        self._sched = sched
        self._marg = marg

    def __len__(self) -> int:
        return self._sched.plan.num_vars

    def __getitem__(self, v: int) -> torch.Tensor:
        plan = self._sched.plan
        c = plan.var_to_clique[v]
        d, gi, slot = self._sched.clique_pos[c]
        axis = plan.clique_vars[c].index(v)
        m = self._marg[(d, gi, axis)][:, slot]
        return m / m.sum(dim=-1, keepdim=True).clamp_min(_TINY)

    def __iter__(self):
        for v in range(len(self)):
            yield self[v]
