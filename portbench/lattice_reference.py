"""The plain reference of an Ising lattice: a transfer sweep.

Plain PyTorch, independent of the program under test: it imports nothing of
``junctiontree_tpu_torch`` and takes only the factors, their values and the
evidence masks the benchmark made.  It is not a junction tree: it sweeps the
lattice's sites in raster order and carries the frontier, the last ``cols``
sites, as one vector of 2^cols states per evidence row (2^(cols + 1) within
a step, while the new site and the one above it are both held).  The
forward sweep gives log Z; a backward sweep over the same frontiers, with
the forward vectors recomputed a lattice row at a time from checkpoints at
the start of each row, gives every spin's posterior.  Each vector is
divided by its largest entry after every step, the logs of the divisors
summed; a row whose evidence is impossible goes to zero and keeps
logZ = -inf.  A posterior multiplies a forward and a backward vector, each
divided by its own largest entry, so their product can fall below
float32's least normal value: it is formed in float64.

Variables are ``s{r}_{c}`` with two states; a factor is a unary or the pair
of two lattice neighbours (several on one scope are multiplied).  TF32 is off
while it runs.  ``tf32`` (float32 only) rounds both operands of every
multiply to TF32 (``reference.to_tf32``): the control of a float32
configuration.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import to_tf32

_SITE = re.compile(r"^s(\d+)_(\d+)$")


def row_blocks(n: int, block: int) -> List[Tuple[int, int]]:
    return [(lo, min(lo + block, n)) for lo in range(0, n, block)]


def _site(label: str) -> Tuple[int, int]:
    m = _SITE.match(label)
    if m is None:
        raise ValueError(f"{label!r} is not a lattice site s<row>_<col>")
    return int(m.group(1)), int(m.group(2))


class LatticeReference:
    """Exact posteriors and log Z of a binary pairwise lattice model.

    ``values`` are the factors' linear values (host arrays).  The sweep
    runs on ``device`` in ``dtype``, every multiply's operands rounded to
    TF32 with ``tf32``."""

    def __init__(self, factors, sizes, values, device=None,
                 dtype=torch.float64, tf32: bool = False):
        sites = {v: _site(v) for v in sizes}
        if any(k != 2 for k in sizes.values()):
            raise ValueError("the lattice reference takes binary spins")
        self.rows = 1 + max(r for r, _ in sites.values())
        self.cols = 1 + max(c for _, c in sites.values())
        if self.cols < 2 or len(sites) != self.rows * self.cols:
            raise ValueError("need a full lattice of at least two columns")
        self.labels = [f"s{r}_{c}" for r in range(self.rows)
                       for c in range(self.cols)]
        if tf32 and dtype != torch.float32:
            raise ValueError("tf32 rounds float32 operands")
        self.device, self.dtype = device, dtype
        self._r = to_tf32 if tf32 else (lambda x: x)
        n = self.rows * self.cols
        unary = np.ones((n, 2))
        left = np.ones((n, 2, 2))      # [x_{t-1}, x_t], site t's left edge
        up = np.ones((n, 2, 2))        # [x_{t-cols}, x_t], its up edge
        for scope, val in zip(factors, values):
            val = np.asarray(val, dtype=np.float64)
            ts = [self._t(sites[v]) for v in scope]
            if len(ts) == 1:
                unary[ts[0]] *= val
                continue
            if len(ts) != 2:
                raise ValueError(f"factor {scope!r}: unary or pair only")
            if ts[0] > ts[1]:
                ts, val = ts[::-1], val.T
            a, b = ts
            if b - a == 1 and b % self.cols:
                left[b] *= val
            elif b - a == self.cols:
                up[b] *= val
            else:
                raise ValueError(f"factor {scope!r}: not lattice neighbours")
        put = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        self.unary, self.left, self.up = put(unary), put(left), put(up)

    def _t(self, rc) -> int:
        return rc[0] * self.cols + rc[1]

    def _local(self, t, masks, R):
        """[R, 2 (x_{t-1}), 2 (x_t)]: site t's unary, evidence and left
        edge (ones at the lattice's left border)."""
        r = self._r
        g = self.unary[t].expand(R, 2)
        if t in masks:
            g = r(g) * r(masks[t])
        g = g[:, None, :]
        if t % self.cols:
            g = r(g) * r(self.left[t][None])
        return g.expand(R, 2, 2)

    @staticmethod
    def _rescale(x):
        """x over its largest entry per row, and the log of that."""
        s = x.amax(dim=1)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        return x / safe[:, None], torch.log(s)

    def _forward(self, phi, t, masks, R):
        """The frontier after site t from the one before it ([R, 2^k])."""
        r = self._r
        g = r(self._local(t, masks, R))
        if t < self.cols:                          # the first lattice row
            phi = r(phi.reshape(R, -1, 2)[..., None]) * g[:, None]
        else:
            y = torch.einsum("ramb,ax->rmbx", r(phi.reshape(R, 2, -1, 2)),
                             r(self.up[t]))
            phi = r(y) * g[:, None]
        return phi.reshape(R, -1)

    def _backward(self, beta, t, masks, R):
        """The future's weight given the frontier before site t, from the
        one given the frontier after it."""
        r = self._r
        g = self._local(t, masks, R)
        y = r(beta.reshape(R, -1, 2, 2)) * r(g[:, None])
        if t < self.cols:
            return y.sum(dim=-1).reshape(R, -1)
        return torch.einsum("rmbx,ax->ramb", r(y),
                            r(self.up[t])).reshape(R, -1)

    def _first(self, masks, R):
        phi = self.unary[0].expand(R, 2)
        if 0 in masks:
            phi = self._r(phi) * self._r(masks[0])
        return phi.contiguous()

    # -- queries ---------------------------------------------------------------
    def posteriors(self, masks: Dict[str, np.ndarray]):
        """(posteriors {label: [rows, 2]}, logZ [rows]) in float64 on the
        host, for linear 0/1 evidence masks {label: [rows, 2]}.  TF32 is
        off for matrix products and cuDNN while it runs."""
        keep = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._sweep(masks)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = keep

    def _sweep(self, masks):
        R = int(next(iter(masks.values())).shape[0])
        m = {self._t(_site(v)): torch.as_tensor(
            np.asarray(x), device=self.device).to(self.dtype)
            for v, x in masks.items()}
        n, W = self.rows * self.cols, self.cols
        # forward: log Z, and the frontier at the end of each lattice row
        phi = self._first(m, R)
        phi, logz = self._rescale(phi)
        marks = {0: phi}
        for t in range(1, n):
            phi, ls = self._rescale(self._forward(phi, t, m, R))
            logz = logz + ls
            if t % W == W - 1:
                marks[t] = phi
        logz = logz + torch.log(phi.sum(dim=1))
        # backward, a lattice row at a time, with its forward frontiers
        post: Dict[int, torch.Tensor] = {}
        beta = torch.ones_like(phi)
        for r in reversed(range(self.rows)):
            lo = r * W
            alphas = [marks[0]] if r == 0 else [marks[lo - 1]]
            for t in range(lo + (r == 0), lo + W):
                alphas.append(self._rescale(
                    self._forward(alphas[-1], t, m, R))[0])
            if r > 0:
                alphas = alphas[1:]
            for t in reversed(range(lo, lo + W)):
                a = alphas[t - lo]
                p = (self._r(a).double() * self._r(beta).double()) \
                    .reshape(R, -1, 2).sum(dim=1)
                tot = p.sum(dim=1, keepdim=True)
                post[t] = torch.where(tot > 0, p / torch.where(
                    tot > 0, tot, torch.ones_like(tot)), torch.zeros_like(p))
                if t > 0:
                    beta = self._rescale(self._backward(beta, t, m, R))[0]
        return ({self.labels[t]: p.double().cpu().numpy()
                 for t, p in post.items()},
                logz.double().cpu().numpy())


def reference(factors, sizes, values, masks, device, dtype=torch.float64,
              tf32: bool = False, budget: int = 8 << 30):
    """The reference's answers for every row of ``masks``, in blocks of
    rows that keep about ``budget`` bytes of frontiers."""
    ref = LatticeReference(factors, sizes, values, device, dtype, tf32)
    rows = len(next(iter(masks.values())))
    item = torch.empty((), dtype=dtype).element_size()
    # the row checkpoints, a lattice row's forward frontiers, the backward
    # one and a step's operands
    per_row = (ref.rows + ref.cols + 8) * (1 << ref.cols) * item
    block = max(1, budget // per_row)
    post, logz = {}, []
    for lo, hi in row_blocks(rows, block):
        p, z = ref.posteriors({v: m[lo:hi] for v, m in masks.items()})
        for v, x in p.items():
            post.setdefault(v, []).append(x)
        logz.append(z)
    return {"post": {v: np.concatenate(x) for v, x in post.items()},
            "logz": np.concatenate(logz)}
