"""UAI competition file-format support (a copy of
``junctiontree_tpu/utils/uai.py``: host code, numpy only).

Implements the standard UAI model format (MARKOV/BAYES preamble, cardinality
list, factor scopes, row-major tables) and the .evid evidence format."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def parse_uai(text: str):
    """Parse UAI model text -> (factors, sizes, values).

    Variable labels are the UAI variable indices (ints).  Factor tables are
    row-major over the declared scope order, matching the spec."""
    # strip comments LINE-wise before tokenizing ('#'/'//' to end of line) —
    # token-level skipping would inject the rest of a multi-word comment
    # into the value stream
    lines = []
    for line in text.splitlines():
        for marker in ("#", "//"):
            ix = line.find(marker)
            if ix >= 0:
                line = line[:ix]
        lines.append(line)
    tokens = "\n".join(lines).split()
    pos = 0

    def take() -> str:
        nonlocal pos
        t = tokens[pos]
        pos += 1
        return t

    network_type = take().upper()
    if network_type not in ("MARKOV", "BAYES"):
        raise ValueError(f"unsupported UAI network type {network_type!r}")
    n_vars = int(take())
    cards = [int(take()) for _ in range(n_vars)]
    n_factors = int(take())
    scopes: List[List[int]] = []
    for _ in range(n_factors):
        arity = int(take())
        scopes.append([int(take()) for _ in range(arity)])
    values: List[np.ndarray] = []
    for scope in scopes:
        n_entries = int(take())
        shape = tuple(cards[v] for v in scope)
        expect = int(np.prod(shape)) if scope else 1
        if n_entries != expect:
            raise ValueError(
                f"factor over {scope} declares {n_entries} entries, expected {expect}"
            )
        flat = np.array([float(take()) for _ in range(n_entries)])
        values.append(flat.reshape(shape) if scope else flat.reshape(()))
    sizes = {v: cards[v] for v in range(n_vars)}
    return scopes, sizes, values


def load_uai(path: str):
    with open(path) as f:
        return parse_uai(f.read())


def parse_evidence(text: str) -> Dict[int, int]:
    """Parse a UAI .evid file: '<n> var val var val ...'."""
    tokens = [int(t) for t in text.split()]
    if not tokens:
        return {}
    n = tokens[0]
    pairs = tokens[1:]
    if len(pairs) < 2 * n:
        raise ValueError("truncated evidence file")
    return {pairs[2 * i]: pairs[2 * i + 1] for i in range(n)}


def load_evidence(path: str) -> Dict[int, int]:
    with open(path) as f:
        return parse_evidence(f.read())


def parse_query(text: str):
    """Parse a UAI .query file (MMAP query-variable set): '<n> var var ...'."""
    tokens = [int(t) for t in text.split()]
    if not tokens:
        return []
    n = tokens[0]
    if len(tokens) < 1 + n:
        raise ValueError("truncated query file")
    return tokens[1:1 + n]


def load_query(path: str):
    with open(path) as f:
        return parse_query(f.read())


def write_uai(factors, sizes, values) -> str:
    """Serialize a factor graph to UAI MARKOV text (inverse of parse_uai);
    variable labels must be the ints 0..n-1."""
    n_vars = len(sizes)
    lines = ["MARKOV", str(n_vars), " ".join(str(sizes[v]) for v in range(n_vars))]
    lines.append(str(len(factors)))
    for scope in factors:
        lines.append(" ".join([str(len(scope))] + [str(v) for v in scope]))
    for scope, val in zip(factors, values):
        flat = np.asarray(val).reshape(-1)
        lines.append(str(flat.size))
        lines.append(" ".join(repr(float(x)) for x in flat))
    return "\n".join(lines) + "\n"
