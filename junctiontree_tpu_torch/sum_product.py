"""Compatibility facade with the reference's ``junctiontree.sum_product``
module (counterpart of ``junctiontree_tpu/sum_product.py``): a
``SumProduct`` class wrapping a pluggable contraction backend with the
reference's interleaved ``einsum(arr0, vars0, arr1, vars1, ..., out_vars)``
calling convention.

Unlike the reference, label interning is deterministic (first-appearance
order, not Python set iteration order, which makes the reference's results
depend on PYTHONHASHSEED)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .executor import resolve_device
from .ops.semirings import SEMIRINGS, SUM_PRODUCT, Semiring, make_subscripts


class SumProduct:
    """Distributive-law wrapper with the reference's interleaved einsum API.

    The contraction backend is pluggable two ways: pass a ``Semiring`` (or
    its name), which contracts on ``device`` (default CUDA device 0), or any
    einsum-compatible callable (e.g. ``np.einsum``) plus default kwargs: the
    callable receives the standard subscripts string and the arrays."""

    def __init__(self, semiring: Semiring = SUM_PRODUCT, device=None,
                 **einsum_kwargs):
        self._einsum_fn = None
        self._einsum_kwargs = einsum_kwargs
        self._device = device
        if isinstance(semiring, str):
            semiring = SEMIRINGS[semiring]
        elif callable(semiring) and not isinstance(semiring, Semiring):
            # injected einsum backend, reference-style
            self._einsum_fn = semiring
            semiring = SUM_PRODUCT
        self.semiring = semiring

    def einsum(self, *args: Any) -> np.ndarray:
        """einsum(arr0, vars0, arr1, vars1, ..., out_vars) with arbitrary
        hashable variable labels."""
        if len(args) % 2 != 1:
            raise ValueError(
                "expected interleaved (array, vars, ..., out_vars) arguments"
            )
        operands = list(args[0:-1:2])
        operand_vars = list(args[1:-1:2])
        out_vars = list(args[-1])
        # deterministic interning: first appearance order
        table: dict = {}
        for vs in operand_vars + [out_vars]:
            for v in vs:
                table.setdefault(v, len(table))
        int_ovs = [[table[v] for v in vs] for vs in operand_vars]
        int_out = [table[v] for v in out_vars]
        if self._einsum_fn is not None:
            return np.asarray(
                self._einsum_fn(
                    make_subscripts(int_ovs, int_out), *operands,
                    **self._einsum_kwargs,
                )
            )
        device = resolve_device(self._device)
        result = self.semiring.contract(
            [torch.as_tensor(np.asarray(o), device=device) for o in operands],
            int_ovs,
            int_out,
        )
        return result.cpu().numpy()
