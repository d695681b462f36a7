"""Forest parallelism: independent tree components on separate devices
(counterpart of ``junctiontree_tpu/parallel/forest.py``).

Disconnected components of a factor graph are joined only by empty
separators, so their propagations are independent.  ``split_components``
factors a factor graph into its connected components; ``ForestEngine``
places one engine per component round-robin over devices and serves them
together, summing the components' log-partitions."""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..evidence import batch_masks_sparse
from ..executor import Engine
from ..schedule import compile_plan
from .mesh import local_cuda_devices


def split_components(
    factors: Sequence[Sequence[Hashable]],
    sizes: Dict[Hashable, int],
) -> List[Tuple[List[int], List[list], Dict[Hashable, int]]]:
    """Partition a factor graph into connected components.

    Returns a list of (factor_indices, component_factors, component_sizes);
    scalar (empty-scope) factors fold into the first component."""
    parent: Dict[Hashable, Hashable] = {}

    def find(x):
        r = x
        while parent.get(r, r) != r:
            r = parent[r]
        while parent.get(x, x) != x:
            parent[x], x = r, parent[x]
        return r

    for f in factors:
        for v in f:
            parent.setdefault(v, v)
        for a, b in zip(f, f[1:]):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

    comps: Dict[Hashable, List[int]] = {}
    scalar_fs: List[int] = []
    for i, f in enumerate(factors):
        if not f:
            scalar_fs.append(i)
            continue
        comps.setdefault(find(f[0]), []).append(i)

    out = []
    for f_ixs in sorted(comps.values(), key=lambda ixs: ixs[0]):
        cf = [list(factors[i]) for i in f_ixs]
        cs = {v: sizes[v] for f in cf for v in f}
        out.append((f_ixs, cf, cs))
    if scalar_fs and out:
        out[0] = (out[0][0] + scalar_fs, out[0][1] + [[] for _ in scalar_fs],
                  out[0][2])
    return out


class ForestEngine:
    """One :class:`Engine` per connected component, placed round-robin over
    ``devices`` (default: every local CUDA device; raises without one).

    Each device runs its components' queries as the host issues them, so
    components on different cards overlap; log-partitions sum across
    components."""

    def __init__(
        self,
        factors: Sequence[Sequence[Hashable]],
        sizes: Dict[Hashable, int],
        devices: Optional[Sequence] = None,
    ):
        self.devices = [torch.device(d) for d in (
            devices if devices is not None else local_cuda_devices())]
        self.components = split_components(factors, sizes)
        self.engines: List[Engine] = []
        self.device_of: List[torch.device] = []
        for k, (_, cf, cs) in enumerate(self.components):
            dev = self.devices[k % len(self.devices)]
            self.engines.append(Engine(compile_plan(cf, cs), device=dev))
            self.device_of.append(dev)

    def set_potentials(self, values: Sequence[np.ndarray]) -> "ForestEngine":
        for eng, (f_ixs, _, _) in zip(self.engines, self.components):
            eng.set_potentials([values[i] for i in f_ixs])
        return self

    def posterior_batch(self, evidence_batch: Sequence[Dict[Hashable, int]]):
        """Batched evidence queries across the whole forest.

        Returns ({var label: [B, size_v] posterior}, total logZ [B]), on
        the first device.  A component with no evidence in the batch runs
        at one row, broadcast to B."""
        B = len(evidence_batch)
        first = self.devices[0]
        results = []
        for eng, (_, _, cs) in zip(self.engines, self.components):
            ev = [{k: v for k, v in e.items() if k in cs}
                  for e in evidence_batch]
            results.append(eng.posterior_batch(batch_masks_sparse(eng.plan, ev)))
        posteriors: Dict[Hashable, torch.Tensor] = {}
        logz = 0.0
        for eng, (post, lz) in zip(self.engines, results):
            logz = lz.to(first).expand(B) + logz
            for v in range(eng.plan.num_vars):
                m = post[v].to(first)
                posteriors[eng.plan.table.label_of(v)] = m.expand(
                    (B,) + tuple(m.shape[1:]))
        return posteriors, logz
