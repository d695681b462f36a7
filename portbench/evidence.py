"""Evidence batches drawn from the run's seed.

``draw_states`` is a frozen, vectorized copy of the program's
``random_evidence_batch``: for each row, in order, one uniform state of
each observed variable, drawn by ``numpy.random.default_rng(seed)
.integers(card)``.  Each such call takes the next 32-bit word of the
generator's stream (the low half of a 64-bit output, then the high half)
and maps it by Lemire's method; a word the method would reject (under
``2**32 mod card`` of its low product, about one in 10**9) sends the draw
back to the scalar loop.  The same seed therefore gives the same states as
the program's helper, at numpy speed.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _scalar_states(seed, B: int, cards: Sequence[int]) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.empty((B, len(cards)), dtype=np.int64)
    for b in range(B):
        for j, k in enumerate(cards):
            out[b, j] = int(rng.integers(k))
    return out


def draw_states(seed, B: int, cards: Sequence[int]) -> np.ndarray:
    """[B, len(cards)] int64 states, row by row as the scalar loop draws
    them."""
    cards_arr = np.asarray(cards, dtype=np.uint64)
    n = B * len(cards)
    if n == 0:
        return np.zeros((B, len(cards)), dtype=np.int64)
    rng = np.random.default_rng(seed)
    raw = rng.bit_generator.random_raw((n + 1) // 2)
    words = np.empty(2 * raw.size, dtype=np.uint64)
    words[0::2] = raw & np.uint64(0xFFFFFFFF)
    words[1::2] = raw >> np.uint64(32)
    k = np.tile(cards_arr, B)
    m = words[:n] * k
    low = m & np.uint64(0xFFFFFFFF)
    threshold = (np.uint64(1 << 32) % k)
    if np.any(low < threshold):
        return _scalar_states(seed, B, cards)
    return (m >> np.uint64(32)).astype(np.int64).reshape(B, len(cards))


def mask_batch(seed, B: int, observed: Sequence[str], sizes: Dict[str, int],
               impossible_rows: Sequence[int] = ()) -> Dict[str, np.ndarray]:
    """Linear 0/1 float32 masks {label: [B, card]} of one evidence batch:
    each row observes every label of ``observed``; in each row of
    ``impossible_rows`` the first observed variable has no allowed state
    (zero likelihood)."""
    states = draw_states(seed, B, [sizes[v] for v in observed])
    out = {}
    for j, v in enumerate(observed):
        m = np.zeros((B, sizes[v]), dtype=np.float32)
        m[np.arange(B), states[:, j]] = 1.0
        out[v] = m
    if observed:
        out[observed[0]][list(impossible_rows)] = 0.0
    return out


def log_masks(masks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Log-space masks (0 / -inf, float32) of linear 0/1 masks."""
    return {k: np.where(m > 0, 0.0, -np.inf).astype(np.float32)
            for k, m in masks.items()}


def pool(seed: int, mix: dict,
         sizes: Dict[str, int]) -> List[Dict[str, np.ndarray]]:
    """The run's evidence: ``mix["pool"]`` batches, batch ``k`` drawn from
    the seed ``[seed, k]``, held on the host as a caller hands them over."""
    return [mask_batch([seed, k], mix["batch"], mix["observed"], sizes,
                       mix.get("impossible_rows", ()))
            for k in range(mix["pool"])]
