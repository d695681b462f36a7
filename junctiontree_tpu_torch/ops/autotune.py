"""Measured comparison of the CUDA kernel with the library, per shape,
cached (counterpart of ``junctiontree_tpu/ops/autotune.py``).

The factored big-clique contraction has two implementations on the card:
the hand-written kernel K1 (``factored_masked_contract``) and two library
products (``library_factored_contract``).  :func:`decide` times both on
ones-filled operands the first time it is asked about a shape, dtype and
card, and caches the faster one, in memory and in a JSON file
(:func:`cache_path`), with the JAX package's rules.

Unlike the JAX package's router, the port serves no decision: the serving
path launches the kernel for every float32 and bfloat16 contraction on the
card (``factored_contract.big_clique_sep_message``), whatever the table
says.  The table is a diagnostic, read by ``Engine.describe()
["kernel_routing"]`` and ``chip_smoke.py``: a winner measured from host
time flips with host noise at the serving shapes, and no benchmark cell yet
shows an end-to-end gain from taking the library.

A cached winner is not trusted forever: the first time a persisted decision
is consulted in a new process, both candidates are timed again and the
incumbent is demoted only when it loses by more than ``REVALIDATE_MARGIN``
(hysteresis).  The margin, both timings and a timestamp are stored with
every entry.

A failure of the kernel is never recorded as a decision: an error raised
while measuring propagates out of :func:`measure` and :func:`decide`, and
nothing is stored for the shape.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Dict, Optional

from ..utils.timing import TIMERS

_LOCK = threading.Lock()
_CACHE: Optional[Dict[str, dict]] = None
# shapes whose cached decision has been re-validated by THIS process; a
# persisted winner is re-measured once per process before being trusted
_VALIDATED: set = set()
# one margin for both rules the JAX package keeps apart (REVALIDATE_MARGIN
# and PALLAS_TIE_BAND, both 1.10): a cached winner is demoted only when it
# loses a fresh measurement by more than this, and a fresh near tie goes to
# the kernel.  Taken from the JAX package, not measured on this card.
REVALIDATE_MARGIN = 1.10
# a library route materializing more than this is "k1" without measuring:
# the intermediate the kernel exists never to build
MAX_LIBRARY_INTERMEDIATE_BYTES = 2 << 30


def cache_path() -> str:
    """The decision file: ``autotune.json`` in ``config.DEFAULT
    .autotune_cache_dir``, or in ``~/.cache/junctiontree_tpu_torch``."""
    from ..config import DEFAULT

    base = DEFAULT.autotune_cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "junctiontree_tpu_torch"
    )
    return os.path.join(base, "autotune.json")


def set_enabled(flag: bool) -> None:
    """Turn the measurement on or off for this process (it writes
    ``config.DEFAULT.autotune``, the one switch); off, :func:`decide`
    answers "k1" without measuring."""
    from ..config import DEFAULT

    DEFAULT.autotune = bool(flag)


def _load() -> Dict[str, dict]:
    global _CACHE
    if _CACHE is None:
        try:
            with open(cache_path()) as f:
                _CACHE = json.load(f)
        except (OSError, ValueError):
            _CACHE = {}
    return _CACHE


def _save() -> None:
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_CACHE, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # persistence is best-effort; the in-memory cache still works


@functools.lru_cache(maxsize=None)
def device_name(device) -> str:
    """The card's name for a CUDA device, else the device type."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _key(R1, R2, C, B, dtype, device) -> str:
    return f"{dtype}:{R1}x{R2}x{C}:B{B}:{device_name(device)}"


def _wall_ms(fn, iters: int = 5) -> float:
    """Best of 3 windows of ``iters`` calls, each ending in a
    synchronisation: host milliseconds per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3


def _device_ms(fn) -> float:
    from ..utils.bench_kernel import device_ms

    return device_ms(fn, iters=10, repeats=3)


def decide(R1: int, R2: int, C: int, B: int, dtype: str = "f32",
           device="cuda") -> str:
    """Return "k1" or "library": which is faster for the contraction shape
    on ``device``, as measured and cached.  No serving path acts on it.

    Order of resolution: an intermediate of the library route above
    ``MAX_LIBRARY_INTERMEDIATE_BYTES`` is "k1" without measuring; so is
    every shape while ``config.DEFAULT.autotune`` is off
    (:func:`set_enabled`); then the decision validated in this process;
    then a fresh measurement, reconciled with a persisted one.  ``dtype``
    ("f32" or "bf16") and the card's name are part of the key.  An error
    while measuring propagates and leaves no entry."""
    inter = min(B * R2 * C, B * R1 * C, B * R1 * R2)
    if inter * 4 > MAX_LIBRARY_INTERMEDIATE_BYTES:
        return "k1"
    from ..config import DEFAULT

    if not DEFAULT.autotune:
        return "k1"
    key = _key(R1, R2, C, B, dtype, device)
    with _LOCK:
        ent = _load().get(key)
        if ent is not None and key in _VALIDATED:
            return ent["winner"]
    fresh = measure(R1, R2, C, B, dtype=dtype, device=device)
    with _LOCK:
        cache = _load()
        ent = cache.get(key)
        new = fresh if ent is None else _reconcile(ent, fresh)
        new["ts"] = round(time.time(), 1)
        new["validations"] = int(ent.get("validations", 0)) + 1 if ent else 1
        w, l = sorted([new["k1_ms"], new["library_ms"]])
        new["margin"] = round(l / w, 3)
        cache[key] = new
        _VALIDATED.add(key)
        _save()
    return new["winner"]


def _reconcile(old: dict, fresh: dict) -> dict:
    """Hysteresis re-validation: keep the incumbent winner unless the fresh
    measurement shows it losing by more than ``REVALIDATE_MARGIN``; then
    demote it (recording the flip).  The returned record carries the FRESH
    timings either way."""
    incumbent = old["winner"]
    t = {"k1": fresh["k1_ms"], "library": fresh["library_ms"]}
    other = "library" if incumbent == "k1" else "k1"
    new = dict(fresh)
    if t[incumbent] > REVALIDATE_MARGIN * t[other]:
        new["winner"] = other
        new["demoted_from"] = incumbent
    else:
        new["winner"] = incumbent
    return new


# the kernel's counters that timing it would add to
_COUNTED = tuple("factored_masked_contract." + k for k in
                 ("launches", "launches_bf16", "launches_backward", "splits"))


def measure(R1: int, R2: int, C: int, B: int, dtype: str = "f32",
            device="cuda") -> dict:
    """Time both candidates on ones-filled operands on ``device``; return
    {winner, k1_ms, library_ms, k1_device_ms, library_device_ms, flops,
    bytes, bound_ms, bound_by}.

    ``*_ms`` are host milliseconds per call (best of 3 windows of 5 calls
    ending in ``torch.cuda.synchronize()``), which decide; ``*_device_ms``
    are device milliseconds with the host running ahead
    (``utils.bench_kernel.device_ms``).  The potential lies in the layout
    ``big_clique_sep_message`` hands the kernel.  ``bound_ms`` is the card's least time for
    the contraction (``contraction_bound``).  A kernel error propagates."""
    import torch

    from .factored_contract import (
        factored_masked_contract,
        library_factored_contract,
        tiles_by_n,
    )

    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    device = torch.device(device)
    if tiles_by_n(C):
        pot = torch.ones((R2, R1, C), dtype=dt, device=device).permute(1, 0, 2)
    else:
        pot = torch.ones((R1, R2, C), dtype=dt, device=device)
    w1 = torch.ones((B, R1), dtype=torch.float32, device=device)
    w2 = torch.ones((B, R2), dtype=dt, device=device)

    def k1():
        return factored_masked_contract(pot, w1, w2)

    def lib():
        return library_factored_contract(pot, w1, w2)

    # the kernel's launch counts are those of the caller's work: launches
    # made here to time it are taken back out
    before = TIMERS.counters()
    try:
        t_k, t_l = _wall_ms(k1), _wall_ms(lib)
        d_k, d_l = _device_ms(k1), _device_ms(lib)
    finally:
        after = TIMERS.counters()
        for name in _COUNTED:
            TIMERS.add(name, before[name] - after[name])
    flops, nbytes, bound, by = contraction_bound(R1, R2, C, B, dtype == "bf16")
    # near ties go to the kernel; see REVALIDATE_MARGIN
    return dict(
        winner="k1" if t_k <= REVALIDATE_MARGIN * t_l else "library",
        k1_ms=round(t_k, 4), library_ms=round(t_l, 4),
        k1_device_ms=round(d_k, 4), library_device_ms=round(d_l, 4),
        flops=int(flops), bytes=int(nbytes),
        bound_ms=round(bound, 4), bound_by=by,
    )


# published peaks of one H100 SXM at its 700 W limit: float32 outside the
# tensor cores, bf16 dense on the tensor cores (operations a second), and
# device memory (bytes a second)
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
# float32 at "highest" as the TPU runs it: six bf16 tensor-core passes
F32_PASSES = 6


def contraction_bound(R1: int, R2: int, C: int, B: int, bf16: bool):
    """(operations, bytes, least milliseconds, "operations" or "bytes") of
    one contraction on the card: the larger of its operations over the peak
    rate of their type and its bytes (each input read once, the output
    written once) over the memory rate.  float32 operations count at the
    rate of six bf16 passes (989 / 6 TFLOP/s), the least time for
    f32-accurate work on the tensor cores, which is how the kernel does it
    (the FMA pipe's 67 TFLOP/s is slower)."""
    ops = 2 * B * R1 * R2 * C + 2 * B * R1 * C
    item = 2 if bf16 else 4
    nbytes = item * (R1 * R2 * C + B * R2) + 4 * (B * R1 + B * C)
    t_ops = ops / (PEAK_BF16 if bf16 else PEAK_BF16 / F32_PASSES) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return ops, nbytes, max(t_ops, t_bytes), (
        "operations" if t_ops > t_bytes else "bytes")


def report() -> Dict[str, dict]:
    """The accumulated decision table (``Engine.describe()
    ["kernel_routing"]``)."""
    with _LOCK:
        return dict(_load())
