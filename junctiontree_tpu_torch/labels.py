"""Variable-label interning.

The reference accepts arbitrary hashable variable labels but its triangulation
heap breaks on non-string labels (heap tie comparisons against the ``""``
invalidation sentinel; see reference construction.py:111-116).
We instead intern every label to a dense int id at the API boundary and run the
whole compiler and executor on ints; labels are only used again when presenting
results to the user.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, Iterable, List, Sequence


class LabelTable:
    """Bidirectional mapping label <-> dense int id (insertion-ordered)."""

    __slots__ = ("_to_id", "_labels")

    def __init__(self) -> None:
        self._to_id: Dict[Hashable, int] = {}
        self._labels: List[Hashable] = []

    def intern(self, label: Hashable) -> int:
        ix = self._to_id.get(label)
        if ix is None:
            ix = len(self._labels)
            self._to_id[label] = ix
            self._labels.append(label)
        return ix

    def intern_all(self, labels: Iterable[Hashable]) -> List[int]:
        return [self.intern(x) for x in labels]

    def id_of(self, label: Hashable) -> int:
        return self._to_id[label]

    def __contains__(self, label: Hashable) -> bool:
        return label in self._to_id

    def label_of(self, ix: int) -> Hashable:
        return self._labels[ix]

    def labels_of(self, ixs: Sequence[int]) -> List[Hashable]:
        return [self._labels[i] for i in ixs]

    def __len__(self) -> int:
        return len(self._labels)

    @property
    def labels(self) -> List[Hashable]:
        return list(self._labels)


def intern_factors(
    factors: Sequence[Sequence[Hashable]],
    sizes: Dict[Hashable, int],
) -> tuple:
    """Intern a factor list + size dict.

    Returns (table, int_factors, int_sizes) where ``int_sizes[i]`` is the
    cardinality of interned variable ``i``.  Only variables that actually
    appear in some factor are interned (mirrors the used-variable filtering at
    reference construction.py:280-287).
    """
    table = LabelTable()
    int_factors: List[List[int]] = []
    for f in factors:
        if not isinstance(f, (list, tuple)):
            raise TypeError(
                "each factor must be a list/tuple of variable labels, got %r" % (f,)
            )
        ivars = table.intern_all(f)
        if len(set(ivars)) != len(ivars):
            raise ValueError("factor %r contains a repeated variable" % (list(f),))
        int_factors.append(ivars)
    int_sizes: List[int] = [0] * len(table)
    for label, ix in table._to_id.items():
        try:
            s = int(sizes[label])
        except KeyError:
            raise KeyError("variable %r missing from sizes" % (label,))
        if s < 1:
            raise ValueError("size of variable %r must be >= 1, got %d" % (label, s))
        int_sizes[ix] = s
    return table, int_factors, int_sizes
