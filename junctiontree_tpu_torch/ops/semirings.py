"""Semirings for message passing (counterpart of
``junctiontree_tpu/ops/semirings.py``).

  * ``SUM_PRODUCT``  linear-space sum-product: contractions are einsums.
  * ``LOG_SUM_EXP``  log-space sum-product: multiply = add, marginalize =
                     logsumexp.  Safe where unnormalized linear beliefs would
                     over- or underflow.
  * ``MAX_PRODUCT``  log-space max-product (MAP): multiply = add,
                     marginalize = max.

``Semiring.contract`` is the generalized einsum "product of operands,
reduced to out_vars" over int-labelled axes.

Contraction order.  The JAX package hands multi-operand einsums to
opt_einsum's path search.  PyTorch contracts left to right unless opt_einsum
happens to be installed, and a left-to-right order on a big clique with
batched messages can build intermediates of tens of GB.  So the port plans
the order itself: :func:`plan_contraction` is a small deterministic greedy
planner that, at each step, contracts the pair of operands whose result is
smallest.  Each pair is then one two-operand ``torch.einsum``, whose order
no installation can change.

Matmul precision.  The JAX package passes ``precision="highest"`` to every
sum-product einsum.  PyTorch has no per-call precision: a process-wide
setting (``torch.set_float32_matmul_precision``) decides whether float32
products may use TF32.  So every product the package takes runs inside
:class:`pinned_precision`, which sets the package's own setting
(:func:`set_matmul_precision`, default ``"highest"``: TF32 off) and restores
the caller's on exit, whatever the process set.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"

# the package's float32 matmul precision: "highest" keeps float32 products
# exact-inference grade (TF32 off); "high" and "default" allow TF32
_MATMUL_PRECISION = "highest"
_TORCH_PRECISION = {"highest": "highest", "high": "high", "default": "high"}


def set_matmul_precision(p: str) -> None:
    """Set the precision of the package's float32 products: "highest"
    (TF32 off, the default), "high" or "default" (TF32 allowed)."""
    global _MATMUL_PRECISION
    if p not in _TORCH_PRECISION:
        raise ValueError(
            f"matmul precision {p!r}: one of {sorted(_TORCH_PRECISION)}"
        )
    _MATMUL_PRECISION = p


def get_matmul_precision() -> str:
    return _MATMUL_PRECISION


# pinned_precision's state, shared by every thread: how many contexts are
# open, and the setting found when the first one opened
_PIN_LOCK = threading.Lock()
_PIN_DEPTH = 0
_PIN_SAVED = "highest"


class pinned_precision:
    """Context in which torch's float32 matmul precision is the package's
    (:func:`get_matmul_precision`).  The setting is process-wide, so open
    contexts are counted across threads: the first to open saves the
    caller's setting and the last to close restores it, and no thread's
    exit lets another thread's product run at the caller's setting.  Costs
    about a microsecond of host time."""

    __slots__ = ()

    def __enter__(self):
        global _PIN_DEPTH, _PIN_SAVED
        want = _TORCH_PRECISION[_MATMUL_PRECISION]
        with _PIN_LOCK:
            if _PIN_DEPTH == 0:
                _PIN_SAVED = torch.get_float32_matmul_precision()
            _PIN_DEPTH += 1
            if torch.get_float32_matmul_precision() != want:
                torch.set_float32_matmul_precision(want)
        return self

    def __exit__(self, *exc):
        global _PIN_DEPTH
        with _PIN_LOCK:
            _PIN_DEPTH -= 1
            if (_PIN_DEPTH == 0
                    and torch.get_float32_matmul_precision() != _PIN_SAVED):
                torch.set_float32_matmul_precision(_PIN_SAVED)
        return False


# log_sum_exp contractions whose union scope has at least this many states
# go through the max-shifted linear einsum (log-matmul-exp) instead of
# broadcast + logsumexp-reduce (see Semiring.contract); read at call time
LOG_EINSUM_MIN_STATES = 1 << 16

_TINY = 1e-38
_LOW_PRECISION = (torch.bfloat16, torch.float16)


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
    if any(x.dtype in _LOW_PRECISION for x in ops):
        ops = [x.float() for x in ops]
    ovs = [list(vs) for vs in operand_vars]
    extent = _extents(ops, ovs)
    with pinned_precision():
        for i, j, res in plan_contraction(ovs, out_vars, extent):
            y = torch.einsum(
                make_subscripts([ovs[i], ovs[j]], res), ops[i], ops[j])
            del ops[j], ops[i], ovs[j], ovs[i]
            ops.append(y)
            ovs.append(res)
        (x,), (vs,) = ops, ovs
        if list(vs) == list(out_vars):
            return x
        return torch.einsum(make_subscripts([vs], out_vars), x)


def _extents(operands, operand_vars) -> Dict[int, int]:
    extent: Dict[int, int] = {}
    for x, vs in zip(operands, operand_vars):
        for d, v in zip(x.shape, vs):
            extent[v] = int(d)
    return extent


def _log_matmul_exp(operands, operand_vars, out_vars) -> torch.Tensor:
    """log-sum-exp contraction as a max-shifted linear einsum: each operand
    is shifted by its global max, exponentiated, and the planned pairwise
    einsum contracts the linear operands, so the union scope is never built.
    Entries more than ~87 nats below an operand's max underflow to the
    semiring zero."""
    lin, tot = [], None
    for x in operands:
        m = x.detach().max()
        # an all -inf operand has no finite max: shift by 0
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        lin.append(torch.exp(x - m))
        tot = m if tot is None else tot + m
    y = _einsum_sum_product(lin, operand_vars, out_vars)
    return torch.where(
        y > 0, torch.log(y.clamp_min(_TINY)), torch.full_like(y, -float("inf"))
    ) + tot


@dataclass(frozen=True)
class Semiring:
    name: str
    is_log: bool
    one: float  # multiplicative identity in this space

    @property
    def zero(self) -> float:
        """Additive identity in this space."""
        return -float("inf") if self.is_log else 0.0

    def reduce(self, x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
        """Marginalize the axes ``dims`` (semiring addition)."""
        dims = tuple(dims)
        if not dims:
            return x
        if self.name == "sum_product":
            return x.sum(dim=dims)
        if self.name == "log_sum_exp":
            return torch.logsumexp(x, dim=dims)
        return x.amax(dim=dims)

    def contract(
        self,
        operands: Sequence[torch.Tensor],
        operand_vars: Sequence[Sequence[int]],
        out_vars: Sequence[int],
    ) -> torch.Tensor:
        """product(operands) marginalized onto out_vars.

        Every out_var must appear in some operand (callers broadcast clique
        scopes explicitly — see executor), so no output-only axes arise here.

        Sum-product is the planned pairwise einsum.  With a bfloat16 or
        float16 operand every operand is widened to float32 first, so each
        pair accumulates and is handed on in float32 and the result is
        float32 (a bf16 ``torch.einsum`` would round between pairs).

        The log semirings broadcast to the union scope, combine and reduce;
        ``log_sum_exp`` with several operands and a union scope of at least
        ``LOG_EINSUM_MIN_STATES`` states takes :func:`_log_matmul_exp`."""
        if not self.is_log:
            return _einsum_sum_product(operands, operand_vars, out_vars)
        scope = _union_scope(operand_vars, out_vars)
        if self.name == "log_sum_exp" and len(operands) > 1:
            extent = _extents(operands, operand_vars)
            if _states([v for v in scope if v in extent], extent) \
                    >= LOG_EINSUM_MIN_STATES:
                return _log_matmul_exp(operands, operand_vars, out_vars)
        acc = _broadcast_to_scope(operands[0], operand_vars[0], scope)
        for x, vs in zip(operands[1:], operand_vars[1:]):
            acc = acc + _broadcast_to_scope(x, vs, scope)
        out_set = set(out_vars)
        acc = self.reduce(
            acc, [i for i, v in enumerate(scope) if v not in out_set]
        )
        rem = [v for v in scope if v in out_set]
        return acc.permute([rem.index(v) for v in out_vars])

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a + b if self.is_log else a * b

    def divide(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Inverse of combine where defined (used only by normalization)."""
        return a - b if self.is_log else a / b

    def to_linear(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(x) if self.is_log else x

    def from_linear(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log(x) if self.is_log else x


SUM_PRODUCT = Semiring(name="sum_product", is_log=False, one=1.0)
LOG_SUM_EXP = Semiring(name="log_sum_exp", is_log=True, one=0.0)
MAX_PRODUCT = Semiring(name="max_product", is_log=True, one=0.0)

SEMIRINGS = {s.name: s for s in (SUM_PRODUCT, LOG_SUM_EXP, MAX_PRODUCT)}
