"""Minimal BIF (Bayesian Interchange Format) reader.

Parses the discrete-variable subset of BIF used by the classic published
networks (ALARM, Insurance, Hailfinder, ... as distributed by the bnlearn
repository): ``variable`` blocks with discrete state lists and
``probability`` blocks with either a ``table`` row (no parents) or one
``(parent states) p1, p2, ...;`` row per parent configuration.

Returns the same (factors, sizes, values) triple the rest of the library
consumes: one factor per CPT with scope [child, parent1, ...] and the
child axis FIRST (value[child_state, parent1_state, ...] = P(child |
parents)), matching models/bayesnet.py's convention.

A copy of ``junctiontree_tpu/utils/bif.py`` (host code, numpy only), so
that published networks can be dropped into ``tests/goldens/`` and served
by this package too."""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np


class BifError(ValueError):
    pass


_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_VARIABLE = re.compile(
    r"variable\s+([\w.\-]+)\s*\{[^}]*?type\s+discrete\s*\[\s*(\d+)\s*\]\s*"
    r"\{([^}]*)\}\s*;[^}]*\}",
    re.S,
)
_PROBABILITY = re.compile(
    r"probability\s*\(\s*([\w.\-]+)\s*(?:\|\s*([\w.\-\s,]+?))?\s*\)\s*"
    r"\{(.*?)\}",
    re.S,
)
_ROW = re.compile(r"\(([^)]*)\)\s*([^;]*);")
_TABLE = re.compile(r"table\s+([^;]*);")


def parse_bif(text: str) -> Tuple[List[List[str]], Dict[str, int], List[np.ndarray]]:
    """BIF text -> (factors, sizes, values); see module docstring."""
    text = _COMMENT.sub("", text)
    states: Dict[str, List[str]] = {}
    for m in _VARIABLE.finditer(text):
        name, n, raw = m.group(1), int(m.group(2)), m.group(3)
        vals = [s.strip() for s in raw.split(",") if s.strip()]
        if len(vals) != n:
            raise BifError(
                f"variable {name}: declared {n} states, found {len(vals)}"
            )
        states[name] = vals
    if not states:
        raise BifError("no discrete variable blocks found")
    sizes = {v: len(s) for v, s in states.items()}

    factors: List[List[str]] = []
    values: List[np.ndarray] = []
    for m in _PROBABILITY.finditer(text):
        child, parents_raw, body = m.group(1), m.group(2), m.group(3)
        if child not in sizes:
            raise BifError(f"probability block for undeclared variable {child}")
        parents = (
            [p.strip() for p in parents_raw.split(",") if p.strip()]
            if parents_raw else []
        )
        for p in parents:
            if p not in sizes:
                raise BifError(f"{child}: undeclared parent {p}")
        shape = [sizes[child]] + [sizes[p] for p in parents]
        table = np.zeros(shape, dtype=np.float64)
        tm = _TABLE.search(body)
        if tm:
            row = [float(x) for x in re.split(r"[,\s]+", tm.group(1).strip())
                   if x]
            if parents:
                # BIF spec table order: the CHILD state varies SLOWEST
                # (the spec's dog-problem `probability (light-on |
                # family-out) { table 0.6 0.05 0.4 0.95; }` means
                # P(t|t)=0.6, P(t|f)=0.05, P(f|t)=0.4, P(f|f)=0.95) —
                # i.e. exactly [child, parents...] C-order, our layout
                want = int(np.prod(shape))
                if len(row) != want:
                    raise BifError(
                        f"{child}: table has {len(row)} entries, want {want}"
                    )
                table = np.asarray(row).reshape(shape)
            else:
                if len(row) != sizes[child]:
                    raise BifError(
                        f"{child}: table has {len(row)} entries, "
                        f"want {sizes[child]}"
                    )
                table = np.asarray(row)
        else:
            seen = 0
            for rm in _ROW.finditer(body):
                cfg = [s.strip() for s in rm.group(1).split(",")]
                if len(cfg) != len(parents):
                    raise BifError(
                        f"{child}: row config {cfg} vs parents {parents}"
                    )
                idx = []
                for p, st in zip(parents, cfg):
                    try:
                        idx.append(states[p].index(st))
                    except ValueError:
                        raise BifError(
                            f"{child}: unknown state {st!r} of parent {p}"
                        )
                row = [float(x) for x in
                       re.split(r"[,\s]+", rm.group(2).strip()) if x]
                if len(row) != sizes[child]:
                    raise BifError(
                        f"{child}: row has {len(row)} entries, "
                        f"want {sizes[child]}"
                    )
                table[(slice(None), *idx)] = row
                seen += 1
            want = int(np.prod([sizes[p] for p in parents])) if parents else 1
            if seen != want:
                raise BifError(
                    f"{child}: {seen} parent-configuration rows, want {want}"
                )
        factors.append([child] + parents)
        values.append(table)

    missing = set(sizes) - {f[0] for f in factors}
    if missing:
        raise BifError(f"variables with no CPT: {sorted(missing)}")
    return factors, sizes, values


def load_bif(path: str):
    with open(path) as f:
        return parse_bif(f.read())
