"""Semirings for message passing (counterpart of
``junctiontree_tpu/ops/semirings.py``).

Only the linear sum-product semiring is ported so far; log-sum-exp and
max-product follow (ROADMAP.md, Queue 1).  ``Semiring.contract`` is the
generalized einsum "product of operands, reduced to out_vars" over
int-labelled axes.

Contraction order.  The JAX package hands multi-operand einsums to
opt_einsum's path search.  PyTorch contracts left to right unless opt_einsum
happens to be installed, and a left-to-right order on a big clique with
batched messages can build intermediates of tens of GB.  So the port plans
the order itself: :func:`plan_contraction` is a small deterministic greedy
planner that, at each step, contracts the pair of operands whose result is
smallest.  Each pair is then one two-operand ``torch.einsum``, whose order
no installation can change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def make_subscripts(
    operand_vars: Sequence[Sequence[int]], out_vars: Sequence[int]
) -> str:
    """Einsum subscripts for int-labelled axes, relabelled to letters per call."""
    local: dict = {}
    for vs in operand_vars:
        for v in vs:
            if v not in local:
                local[v] = _LETTERS[len(local)]
    for v in out_vars:
        if v not in local:
            local[v] = _LETTERS[len(local)]
    ins = ",".join("".join(local[v] for v in vs) for vs in operand_vars)
    outs = "".join(local[v] for v in out_vars)
    return ins + "->" + outs


def _union_scope(operand_vars: Sequence[Sequence[int]], out_vars: Sequence[int]):
    scope: List[int] = []
    seen = set()
    for vs in list(operand_vars) + [list(out_vars)]:
        for v in vs:
            if v not in seen:
                seen.add(v)
                scope.append(v)
    return scope


def _broadcast_to_scope(
    x: torch.Tensor, vs: Sequence[int], scope: Sequence[int]
) -> torch.Tensor:
    """Transpose/expand x (axes labelled vs) to the full scope layout."""
    pos = {v: i for i, v in enumerate(vs)}
    perm = [pos[v] for v in scope if v in pos]
    x = x.permute(perm)
    shape_ix = 0
    new_shape = []
    for v in scope:
        if v in pos:
            new_shape.append(x.shape[shape_ix])
            shape_ix += 1
        else:
            new_shape.append(1)
    return x.reshape(new_shape)


def _states(vs: Sequence[int], extent: Dict[int, int]) -> int:
    n = 1
    for v in vs:
        n *= extent[v]
    return n


def plan_contraction(
    operand_vars: Sequence[Sequence[int]],
    out_vars: Sequence[int],
    extent: Dict[int, int],
) -> List[Tuple[int, int, List[int]]]:
    """Greedy pairwise contraction order over variable-labelled operands.

    Returns steps ``(i, j, result_vars)`` with ``i < j``: operands ``i`` and
    ``j`` of the current working list are removed and their product,
    reduced to ``result_vars``, is appended.  A result keeps a variable only
    if another remaining operand or the output still needs it.  Each step
    takes the pair with the fewest result states (ties: lowest ``(i, j)``),
    so the order is deterministic.  After the last step one operand remains;
    the caller reduces it to ``out_vars``."""
    ops = [list(vs) for vs in operand_vars]
    out_set = set(out_vars)
    steps: List[Tuple[int, int, List[int]]] = []
    while len(ops) > 1:
        best = None
        for i in range(len(ops)):
            for j in range(i + 1, len(ops)):
                need = set(out_set)
                for k, vs in enumerate(ops):
                    if k != i and k != j:
                        need.update(vs)
                res = [v for v in _union_scope([ops[i], ops[j]], []) if v in need]
                key = (_states(res, extent), i, j)
                if best is None or key < best[0]:
                    best = (key, res)
        (_, i, j), res = best
        steps.append((i, j, res))
        del ops[j], ops[i]
        ops.append(res)
    return steps


def _einsum_sum_product(
    operands: Sequence[torch.Tensor],
    operand_vars: Sequence[Sequence[int]],
    out_vars: Sequence[int],
) -> torch.Tensor:
    ops = list(operands)
    ovs = [list(vs) for vs in operand_vars]
    extent: Dict[int, int] = {}
    for x, vs in zip(ops, ovs):
        for d, v in zip(x.shape, vs):
            extent[v] = int(d)
    for i, j, res in plan_contraction(ovs, out_vars, extent):
        y = torch.einsum(make_subscripts([ovs[i], ovs[j]], res), ops[i], ops[j])
        del ops[j], ops[i], ovs[j], ovs[i]
        ops.append(y)
        ovs.append(res)
    (x,), (vs,) = ops, ovs
    if list(vs) == list(out_vars):
        return x
    return torch.einsum(make_subscripts([vs], out_vars), x)


@dataclass(frozen=True)
class Semiring:
    name: str
    is_log: bool
    one: float  # multiplicative identity in this space

    def contract(
        self,
        operands: Sequence[torch.Tensor],
        operand_vars: Sequence[Sequence[int]],
        out_vars: Sequence[int],
    ) -> torch.Tensor:
        """product(operands) marginalized onto out_vars.

        Every out_var must appear in some operand (callers broadcast clique
        scopes explicitly — see executor), so no output-only axes arise here.
        """
        return _einsum_sum_product(operands, operand_vars, out_vars)

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a * b


SUM_PRODUCT = Semiring(name="sum_product", is_log=False, one=1.0)

SEMIRINGS = {s.name: s for s in (SUM_PRODUCT,)}
