"""The plain reference: exact inference on a junction tree of its own.

Plain PyTorch, independent of the program under test: it imports nothing
of ``junctiontree_tpu_torch`` and takes only the factors, their values and
the evidence masks that the benchmark itself made.  It triangulates the
moral graph by greedy min-weight elimination, joins the maximal cliques by
a maximum spanning tree on separator size, and runs Shafer-Shenoy message
passing (no division, so zero-likelihood evidence needs no special case)
over a block of evidence rows at a time.

Sum-product messages are one ``torch.einsum`` of the (unbatched) clique
potential with the outer product of the batched operands (masks and
incoming messages), so their contractions are matrix products: in float32
with TF32 allowed they run in TF32, which is what the benchmark's control
asks of them.  Max-product works in log space: the batched clique scores
are materialized and maximized.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXY"


def triangulate(factors: Sequence[Sequence[str]], sizes: Dict[str, int]):
    """Greedy min-weight elimination of the moral graph: the variable whose
    elimination clique has the fewest states goes first (ties: fewer
    fill-in edges, then the earlier variable).  Returns the maximal
    elimination cliques as lists of labels."""
    order = list(sizes)
    nbrs = {v: set() for v in order}
    for f in factors:
        for a in f:
            nbrs[a].update(b for b in f if b != a)
    rank = {v: i for i, v in enumerate(order)}
    left = set(order)
    cliques: List[set] = []
    while left:
        best = None
        for v in left:
            ns = list(nbrs[v])
            fill = sum(1 for i, a in enumerate(ns) for b in ns[i + 1:]
                       if b not in nbrs[a])
            weight = math.prod(sizes[u] for u in ns) * sizes[v]
            key = (weight, fill, rank[v])
            if best is None or key < best[0]:
                best = (key, v)
        v = best[1]
        clique = nbrs[v] | {v}
        if not any(clique <= c for c in cliques):
            cliques.append(clique)
        for a in nbrs[v]:
            nbrs[a].update(b for b in nbrs[v] if b != a)
            nbrs[a].discard(v)
        left.discard(v)
        del nbrs[v]
    return [sorted(c, key=rank.get) for c in cliques]


def spanning_tree(cliques: List[List[str]]):
    """Maximum spanning tree on separator size (Kruskal), as (i, j) edges."""
    edges = sorted(
        ((len(set(a) & set(b)), i, j)
         for i, a in enumerate(cliques) for j, b in enumerate(cliques)
         if i < j),
        key=lambda e: (-e[0], e[1], e[2]))
    root = list(range(len(cliques)))

    def find(x):
        while root[x] != x:
            root[x] = root[root[x]]
            x = root[x]
        return x

    tree = []
    for _, i, j in edges:
        ri, rj = find(i), find(j)
        if ri != rj:
            root[ri] = rj
            tree.append((i, j))
    return tree


class Reference:
    """Exact inference on the benchmark's own junction tree.

    ``values`` are the factors' linear values (host arrays).  The clique
    potentials are formed on ``device`` in ``dtype``; ``semiring`` is "sum"
    (linear, for posteriors and logZ) or "max" (log space, for MAP
    scores).  ``tf32`` (float32 only) rounds both operands of every
    sum-product contraction to TF32, as the card's TF32 matrix products do
    whichever kernel runs them.  Without ``values`` only the tree is built
    (for :meth:`operations`)."""

    def __init__(self, factors, sizes, values=None, device=None,
                 dtype=torch.float64, semiring: str = "sum",
                 tf32: bool = False):
        if semiring not in ("sum", "max"):
            raise ValueError(f"semiring {semiring!r}: 'sum' or 'max'")
        self.sizes, self.device, self.dtype = dict(sizes), device, dtype
        self.tf32 = tf32
        self.semiring = semiring
        self.cliques = triangulate(factors, sizes)
        edges = spanning_tree(self.cliques)
        n = len(self.cliques)
        adj = {i: [] for i in range(n)}
        for i, j in edges:
            adj[i].append(j)
            adj[j].append(i)
        # root at the largest clique; parents before children in ``order``
        self.root = max(range(n), key=lambda c: (self.states(c), -c))
        self.parent = {self.root: None}
        self.order = [self.root]
        for c in self.order:
            for d in adj[c]:
                if d not in self.parent:
                    self.parent[d] = c
                    self.order.append(d)
        self.children = {c: [d for d in adj[c] if self.parent.get(d) == c]
                         for c in range(n)}
        # each factor and each variable's evidence to the smallest clique
        # that holds it
        def home(scope):
            fits = [c for c in range(n) if set(scope) <= set(self.cliques[c])]
            return min(fits, key=lambda c: (self.states(c), c))

        self.var_home = {v: home([v]) for v in sizes}
        self.pots = []
        if values is None:
            return
        for c in range(n):
            shape = [sizes[v] for v in self.cliques[c]]
            one = 0.0 if semiring == "max" else 1.0
            self.pots.append(torch.full(shape, one, dtype=torch.float64,
                                        device=device))
        for scope, val in zip(factors, values):
            c = home(scope)
            t = torch.as_tensor(np.asarray(val, dtype=np.float64),
                                device=device)
            if semiring == "max":
                t = torch.log(t)
            t = self._broadcast(t, list(scope), self.cliques[c])
            if semiring == "max":
                self.pots[c] += t
            else:
                self.pots[c] *= t
        self.pots = [p.to(dtype) for p in self.pots]

    def states(self, c: int) -> int:
        return math.prod(self.sizes[v] for v in self.cliques[c])

    def max_states(self) -> int:
        return max(self.states(c) for c in range(len(self.cliques)))

    def operations(self, B: int) -> int:
        """Operations of one pass over B rows: a multiply and an add (or an
        add and a max) per clique state and row for every message a clique
        sends and for the marginals and partition it gives."""
        total = 0
        for c in range(len(self.cliques)):
            sends = (self.parent[c] is not None) + len(self.children[c])
            outs = sum(1 for v in self.var_home.values() if v == c)
            total += (sends + outs + (c == self.root)) * self.states(c)
        return 2 * B * total

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _broadcast(t, tvars, cvars, batched=False):
        """``t`` (axes ``tvars``, leading row axis if ``batched``) viewed in
        the axis order of ``cvars``, size 1 where it has no axis."""
        lead = 1 if batched else 0
        perm = list(range(lead)) + [lead + tvars.index(v) for v in cvars
                                    if v in tvars]
        t = t.permute(perm)
        shape = list(t.shape[:lead]) + [
            t.shape[lead + [u for u in cvars if u in tvars].index(v)]
            if v in tvars else 1 for v in cvars]
        return t.reshape(shape)

    def _scores(self, c, ops, rows):
        """Clique ``c``'s log potential plus the batched log operands
        ``ops``: [rows, *clique]."""
        cv = self.cliques[c]
        acc = self.pots[c].unsqueeze(0)
        for vs, t in ops:
            acc = acc + self._broadcast(t, list(vs), cv, batched=True)
        return acc.expand((rows,) + tuple(acc.shape[1:]))

    def _contract(self, c, ops, out_vars, rows):
        """Sum (or max) of clique ``c``'s potential times the batched
        operands ``ops`` ([(vars, [rows, ...])]) onto ``out_vars``:
        [rows, *out]."""
        cv = self.cliques[c]
        pot = self.pots[c]
        if self.semiring == "max":
            acc = self._scores(c, ops, rows)
            drop = [1 + i for i, v in enumerate(cv) if v not in out_vars]
            if drop:
                acc = acc.amax(dim=drop)
            keep = [v for v in cv if v in out_vars]
            return acc.permute([0] + [1 + keep.index(v) for v in out_vars])
        if not ops:
            keep = [v for v in cv if v in out_vars]
            drop = [i for i, v in enumerate(cv) if v not in out_vars]
            y = pot.sum(dim=drop) if drop else pot
            perm = [keep.index(v) for v in out_vars]
            return y.permute(perm).unsqueeze(0).expand((rows,) + tuple(
                self.sizes[v] for v in out_vars))
        union = [v for v in cv if any(v in vs for vs, _ in ops)]
        w = None
        for vs, t in ops:
            t = self._broadcast(t, list(vs), union, batched=True)
            w = t if w is None else w * t
        w = w.expand((rows,) + tuple(self.sizes[v] for v in union))
        sub = {v: _LETTERS[i] for i, v in enumerate(cv)}
        expr = "{},Z{}->Z{}".format("".join(sub[v] for v in cv),
                                    "".join(sub[v] for v in union),
                                    "".join(sub[v] for v in out_vars))
        if self.tf32:
            pot, w = to_tf32(pot), to_tf32(w)
        return torch.einsum(expr, pot, w)

    def _sep(self, a, b):
        return [v for v in self.cliques[a] if v in self.cliques[b]]

    def _collect(self, ops_of, rows):
        """The messages towards the root, leaves first: {(from, to): (sep
        vars, [rows, *sep])}."""
        msg = {}
        for c in reversed(self.order):
            p = self.parent[c]
            if p is None:
                continue
            ops = ops_of(c) + [msg[(d, c)] for d in self.children[c]]
            s = self._sep(c, p)
            msg[(c, p)] = (s, self._contract(c, ops, s, rows))
        return msg

    def _messages(self, ops_of, rows):
        """Shafer-Shenoy: every message of the tree, both ways."""
        msg = self._collect(ops_of, rows)
        sep = self._sep
        for c in self.order:                    # distribute, root first
            for d in self.children[c]:
                ops = ops_of(c) + [msg[(e, c)] for e in self.children[c]
                                   if e != d]
                if self.parent[c] is not None:
                    ops.append(msg[(self.parent[c], c)])
                s = sep(c, d)
                msg[(c, d)] = (s, self._contract(c, ops, s, rows))
        return msg

    def _incoming(self, c, msg):
        near = list(self.children[c])
        if self.parent[c] is not None:
            near.append(self.parent[c])
        return [msg[(d, c)] for d in near]

    def _ops_of(self, masks):
        by_clique: Dict[int, list] = {}
        for v, m in masks.items():
            m = torch.as_tensor(m, device=self.device).to(self.dtype)
            by_clique.setdefault(self.var_home[v], []).append(((v,), m))
        return lambda c: list(by_clique.get(c, []))

    # -- queries -------------------------------------------------------------
    def posteriors(self, masks: Dict[str, np.ndarray]):
        """(posteriors {label: [rows, card]}, logZ [rows]) in float64 on the
        host, for linear 0/1 evidence masks {label: [rows, card]}."""
        if self.semiring != "sum":
            raise ValueError("posteriors need the 'sum' semiring")
        rows = int(next(iter(masks.values())).shape[0])
        ops_of = self._ops_of(masks)
        msg = self._messages(ops_of, rows)
        # Z as the total of an unnormalized marginal at the root, so that
        # every sum the reference makes is a matrix product
        root_ops = ops_of(self.root) + self._incoming(self.root, msg)
        z = self._contract(self.root, root_ops, self.cliques[self.root][:1],
                           rows).double().sum(dim=1)
        post = {}
        for v, c in self.var_home.items():
            m = self._contract(c, ops_of(c) + self._incoming(c, msg), [v],
                               rows).double()
            tot = m.sum(dim=1, keepdim=True)
            post[v] = torch.where(tot > 0, m / torch.where(
                tot > 0, tot, 1.0), 0.0).cpu().numpy()
        with np.errstate(divide="ignore"):
            logz = np.log(z.cpu().numpy())
        return post, logz

    def map_decode(self, log_masks: Dict[str, np.ndarray]):
        """(best full assignment {label: [rows] states}, its log score
        [rows]) for each row of log-space masks (0 / -inf), on the host:
        max-product towards the root, then each clique's best states given
        its parent's, root first.  The score is -inf where no assignment is
        feasible (the assignment is then arbitrary)."""
        if self.semiring != "max":
            raise ValueError("MAP needs the 'max' semiring")
        rows = int(next(iter(log_masks.values())).shape[0])
        ops_of = self._ops_of(log_masks)
        msg = self._collect(ops_of, rows)
        assign: Dict[str, torch.Tensor] = {}
        score = None
        for c in self.order:
            cv = self.cliques[c]
            ops = ops_of(c) + [msg[(d, c)] for d in self.children[c]]
            for v in cv:
                if v in assign:             # the parent's choice
                    pick = torch.full((rows, self.sizes[v]), -math.inf,
                                      dtype=self.dtype, device=self.device)
                    pick.scatter_(1, assign[v][:, None], 0.0)
                    ops.append(((v,), pick))
            best, idx = self._scores(c, ops, rows).reshape(rows, -1).max(1)
            if score is None:
                score = best
            shape = [self.sizes[v] for v in cv]
            for i, v in enumerate(cv):
                stride = math.prod(shape[i + 1:])
                if v not in assign:
                    assign[v] = (idx // stride) % shape[i]
        return ({v: a.cpu().numpy() for v, a in assign.items()},
                score.double().cpu().numpy())


def score_assignments(factors, values, assign: Dict[str, np.ndarray],
                      log_masks: Dict[str, np.ndarray]) -> np.ndarray:
    """Log score, in float64, of each row's full assignment ({label: [rows]
    states}): the sum of the log factor values it picks plus its evidence
    masks (-inf where it contradicts the evidence)."""
    rows = len(next(iter(assign.values())))
    total = np.zeros(rows)
    with np.errstate(divide="ignore"):
        for scope, val in zip(factors, values):
            idx = tuple(np.asarray(assign[v], dtype=np.int64) for v in scope)
            total += np.log(np.asarray(val, dtype=np.float64)[idx])
        for v, m in log_masks.items():
            total += np.asarray(m, dtype=np.float64)[
                np.arange(rows), np.asarray(assign[v], dtype=np.int64)]
    return total


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties to even; infinities and zeros stay as they are."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return torch.where(torch.isfinite(t), rounded.view(torch.float32), t)


def row_blocks(n: int, block: int) -> List[Tuple[int, int]]:
    return [(lo, min(lo + block, n)) for lo in range(0, n, block)]
