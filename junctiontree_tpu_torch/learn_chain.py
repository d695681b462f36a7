"""MLE learning on chain-structured models at production scale
(counterpart of ``junctiontree_tpu/learn_chain.py``).

The generic learners (``learn.py``) run one contraction per clique.  Here
the per-factor log-potentials are packed host-side into a handful of
STACKED parameter tensors (grouped by how each factor lands in its chain
clique), the [m, K, K] transition stack is built with one ``index_add`` per
group, and logZ runs through the forward half of the chain program
(``scan_executor.chain_logz_program``), which is functional when its
transitions require a gradient.

Supports missing data out of the box: the objective is

    mean_b logZ(evidence_b) - logZ            (observed-data log-likelihood)

whose gradient is E[phi | observed] - E[phi] (gradient EM), identical to
``learn.fit_mle_missing`` but scalable to long chains.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .executor import resolve_device
from .learn import _adam_ascent
from .scan_executor import ChainLayout, chain_logz_program
from .schedule import Plan


class _ChainParams:
    """Host-side packing of per-factor thetas into stacked group tensors.

    Groups (all shapes in the clique's (v_k, v_{k+1}) orientation):
      pair  — two-variable factors: stacked [n_pair, K, K] (+ transpose flag
              folded in at pack time)
      head  — single-variable factors on axis 0 of their clique: [n0, K]
      tail  — single-variable factors on axis 1: [n1, K]
    """

    def __init__(self, plan: Plan, layout: ChainLayout):
        self.plan = plan
        self.layout = layout
        pos_of_clique = {c: k for k, c in enumerate(layout.clique_order)}
        self.spec: List[Tuple[str, int, bool]] = []  # (group, k, flip)
        for fi, fvars in enumerate(plan.factors):
            cf = plan.tri.factor_to_maxclique[fi]
            k = pos_of_clique[cf]
            vk = layout.var_order[k]
            if len(fvars) == 2:
                self.spec.append(("pair", k, fvars[0] != vk))
            elif len(fvars) == 1:
                self.spec.append(
                    ("head", k, False) if fvars[0] == vk else ("tail", k, False)
                )
            else:
                raise ValueError(
                    "chain learner supports factors of arity 1 or 2; factor "
                    f"{fi} has {len(fvars)} variables"
                )
        self.groups: Dict[str, List[int]] = {"pair": [], "head": [], "tail": []}
        for fi, (g, k, _) in enumerate(self.spec):
            self.groups[g].append(fi)
        self.ks = {
            g: np.asarray([self.spec[fi][1] for fi in fis], dtype=np.int64)
            for g, fis in self.groups.items()
        }

    def pack(
        self, thetas: Sequence[np.ndarray], device, dtype: torch.dtype
    ) -> Dict[str, torch.Tensor]:
        K = self.layout.card
        out = {}
        for g, fis in self.groups.items():
            if not fis:
                out[g] = torch.zeros(
                    (0, K, K) if g == "pair" else (0, K), dtype=dtype,
                    device=device,
                )
                continue
            mats = []
            for fi in fis:
                t = np.asarray(thetas[fi])
                if self.spec[fi][2]:
                    t = t.T
                mats.append(t)
            out[g] = torch.as_tensor(np.stack(mats), dtype=dtype, device=device)
        return out

    def unpack(self, packed: Dict[str, torch.Tensor]) -> List[np.ndarray]:
        thetas: List[Optional[np.ndarray]] = [None] * len(self.plan.factors)
        for g, fis in self.groups.items():
            arr = packed[g].detach().cpu().numpy()
            for i, fi in enumerate(fis):
                t = arr[i]
                if self.spec[fi][2]:
                    t = t.T
                thetas[fi] = t
        return thetas  # type: ignore[return-value]

    def build_logA(self, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[m, K, K] log-transition stack from packed group tensors: one
        ``index_add`` per group regardless of chain length."""
        m = len(self.layout.clique_order)
        K = self.layout.card
        ref = packed["pair"]
        logA = torch.zeros((m, K, K), dtype=ref.dtype, device=ref.device)
        for g, src in (
            ("pair", packed["pair"]),
            ("head", packed["head"][:, :, None].expand(-1, K, K)),
            ("tail", packed["tail"][:, None, :].expand(-1, K, K)),
        ):
            if len(self.groups[g]):
                at = torch.as_tensor(self.ks[g], device=ref.device)
                logA = logA.index_add(0, at, src)
        return logA


def chain_masks_from_data(
    plan: Plan, layout: ChainLayout, data: np.ndarray, missing: int = -1
) -> np.ndarray:
    """[m+1, N, K] linear one-hot/ones mask stack in chain order."""
    N = data.shape[0]
    m = len(layout.clique_order)
    K = layout.card
    M = np.ones((m + 1, N, K), dtype=np.float32)
    for k, v in enumerate(layout.var_order):
        col = np.asarray(data[:, v])
        obs = col != missing
        if np.any((col[obs] < 0) | (col[obs] >= K)):
            raise ValueError(f"state out of range for var id {v}")
        M[k, obs, :] = 0.0
        M[k, obs, col[obs]] = 1.0
    return M


def fit_mle_chain(
    plan: Plan,
    data: np.ndarray,
    steps: int = 200,
    learning_rate: float = 0.1,
    init_thetas: Optional[Sequence[np.ndarray]] = None,
    missing: int = -1,
    verbose: bool = False,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[List[np.ndarray], List[float]]:
    """Gradient MLE on a chain plan (complete or missing data).

    Same contract as ``learn.fit_mle_missing`` (returns per-factor thetas +
    per-step avg observed-data log-likelihood) through the chain program,
    on ``device`` (default CUDA device 0) in ``dtype``.  Requires the plan
    to be a uniform chain (``ChainLayout.detect``)."""
    layout = ChainLayout.detect(plan)
    if layout is None:
        raise ValueError(
            "fit_mle_chain requires a uniform chain plan; use learn.fit_mle"
            "/fit_mle_missing for general trees"
        )
    device = resolve_device(device)
    params = _ChainParams(plan, layout)
    if init_thetas is None:
        init_thetas = [
            np.zeros(tuple(plan.sizes[v] for v in f)) for f in plan.factors
        ]
    packed = params.pack(init_thetas, device, dtype)
    leaves = [p.requires_grad_(True) for p in packed.values() if p.numel()]
    masks = torch.as_tensor(
        chain_masks_from_data(plan, layout, data, missing), dtype=dtype,
        device=device,
    )
    # one more row, all ones: the free logZ rides the same forward loop as
    # the data rows (rows are independent), one pass a step, not two
    masks = torch.cat([masks, torch.ones_like(masks[:, :1])], dim=1)
    logz = chain_logz_program(plan, layout)

    def neg_loglik():
        lz = logz(torch.exp(params.build_logA(packed)), masks)
        return lz[-1] - lz[:-1].mean()

    history = _adam_ascent(
        leaves, neg_loglik, steps, learning_rate, verbose,
        "loglik",
    )
    return params.unpack(packed), history
