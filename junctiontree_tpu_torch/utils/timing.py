"""The port's one recorder of phases, spans and counters (SURVEY.md §5
tracing row: the reference has no instrumentation at all).

* **Phases** (``TIMERS.phase(name)``): wall-clock totals of rare work
  (compiling a plan, evaluating and uploading potentials, building a
  program, making a kept K1 layout), always on; ``totals``, ``counts``,
  ``report()``.
* **Spans** (``TIMERS.call(name)`` at a serving entry point,
  ``TIMERS.span(name, **attrs)`` inside it): recorded only while a
  ``torch.profiler`` records, read once at the call's root.  A recorded
  span is stamped on the profiler's own clock (``time.time_ns()``, the
  Unix clock kineto's events carry) and also entered as
  ``torch.profiler.record_function(name)``, so the same range lies in the
  profiler's timeline over the device lanes.  A finished call goes to a
  bounded ring, ``TIMERS.calls()``: its spans and its change in every
  counter.  With no profiler recording, a span is one check of a flag and
  a shared no-op context: no clock read, no ``record_function``.
* **Counters** (``TIMERS.add(name, n)``): always on, one integer add at a
  site.  Every counter of the port is named in :data:`COUNTERS`, and
  ``TIMERS.counters()`` is their one table.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("junctiontree_tpu_torch")

# every counter of the port, each a process-wide running total
COUNTERS = (
    # launches of the big-clique kernel (``ops.factored_contract``): all,
    # those with bf16 inputs, and those made by a backward pass
    "factored_masked_contract.launches",
    "factored_masked_contract.launches_bf16",
    "factored_masked_contract.launches_backward",
    # float32 potentials split into the kernel's bf16 planes, and w2 or
    # bf16 pot operands copied into an aligned buffer first
    "factored_masked_contract.splits",
    "factored_masked_contract.padded",
    # float32 tensor-core launches that read the route's w2 by broadcast
    # (its group weights, with no [B, R2] copy)
    "factored_masked_contract.broadcast",
    # contractions of the big-clique route (``big_clique_sep_message``), and
    # those of a clique of at least ``big_clique_min_states`` states with
    # batched operands that the route refused (``executor``: a message
    # crossing the separator boundary, an operand outside the clique)
    "big_clique_sep_message.calls",
    "big_clique_sep_message.refused",
    # the general program's planned contractions (``executor._bcontract``)
    "route.einsum_calls",
    # compiles whose greedy min-fill plan escalated (``schedule``)
    "compile.escalations",
    # kernel operands found kept beside a standing potential, made (kept or
    # not), and put out for another (``ops.factored_contract.kept``)
    "kept.hits",
    "kept.misses",
    "kept.evictions",
    # launches of the chain step's row kernel (``ops.chain_step.rows``)
    "chain_step.launches",
    # bytes of the batch-by-state operands the big-clique route writes: w2
    # expanded over the uncovered rest axes, and any copy the kernel
    # wrapper makes of w1 or w2
    "route.materialized_bytes",
    # bytes of each new [b, *clique] tensor of the tree-MAP programs (a
    # masked potential, an out-of-place add) and of the (sep, rest)
    # permuted copy where the permute copies
    "map.materialized_bytes",
    # cliques of the tree-MAP program collected by the fused kernel
    # (``ops.map_collect``), and the b x clique_states pairs they covered
    "map.fused_cliques",
    "map.fused_states",
    # bytes of the evidence masks the serving entry points place from the
    # host onto the engine's device
    "serve.mask_bytes",
    # [B, K] x [K, K] products of the chain program's forward and backward
    # passes (``scan_executor``), and the leaf variables whose posteriors
    # the HMM program gave
    "chain.products",
    "chain.leaf_vars",
)

CALL_RING = 256  # call records kept by ``TIMERS.calls()``


@dataclass
class Span:
    """One recorded range: ``start_ns`` / ``end_ns`` on the profiler's
    clock (Unix nanoseconds), ``parent`` the index of the enclosing span in
    its call's ``spans`` (None for the call's root), ``call`` the call's
    id, ``attrs`` what the site noted."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class CallRecord:
    """One serving call recorded under a profiler: ``spans[0]`` is its
    root, the others follow in the order they opened; ``counters`` is the
    call's change in every counter of :meth:`PhaseTimers.counters`."""
    id: int
    spans: List[Span]
    counters: Dict[str, int] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.spans[0].name

    @property
    def seconds(self) -> float:
        """Host seconds from the entry point's start to its return."""
        return self.spans[0].seconds

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


class _Open(threading.local):
    """The call a thread is recording (None outside one) and the indices of
    its open spans, innermost last."""
    call: Optional[CallRecord] = None
    stack: List[int] = ()  # a list of the thread's own once a call opens


class _NoSpan:
    """What a span is while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Range:
    """A recorded span: a ``record_function`` range, and a :class:`Span`
    of the open call (which a root opens and closes)."""

    __slots__ = ("timers", "name", "attrs", "root", "rf", "index", "before")

    def __init__(self, timers: "PhaseTimers", name: str, attrs: dict,
                 root: bool):
        self.timers, self.name, self.attrs, self.root = (
            timers, name, attrs, root)

    def __enter__(self):
        t, st = self.timers, self.timers._open
        if self.root:
            self.before = t.counters()
            st.call = CallRecord(next(t._ids), [])
            st.stack = []
        call = st.call
        self.index = len(call.spans)
        call.spans.append(Span(self.name, 0, 0,
                               st.stack[-1] if st.stack else None, call.id,
                               self.attrs))
        st.stack.append(self.index)
        self.rf = _autograd_profiler.record_function(self.name)
        # the stamps enclose the profiler's own, which it takes inside
        # entering and leaving the range
        call.spans[self.index].start_ns = time.time_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        t, st = self.timers, self.timers._open
        call = st.call
        self.rf.__exit__(None, None, None)
        call.spans[self.index].end_ns = time.time_ns()
        st.stack.pop()
        if self.root:
            after = t.counters()
            call.counters = {k: v - self.before.get(k, 0)
                             for k, v in after.items()}
            st.call = None
            t._calls.append(call)
        return False


class PhaseTimers:
    """Phases (always on), spans (while a profiler records) and counters
    (always on); see the module's docstring."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.tally: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
        self._open = _Open()
        self._calls: collections.deque = collections.deque(maxlen=CALL_RING)
        self._ids = itertools.count()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Time a block into ``totals[name]`` and ``counts[name]``; while a
        profiler records, also a span (inside a recorded call) or a
        ``record_function`` range (outside one)."""
        if self._open.call is not None:
            rng = _Range(self, name, {}, False)
        elif _autograd_profiler._is_profiler_enabled:
            rng = _autograd_profiler.record_function(name)
        else:
            rng = _NO_SPAN
        t0 = time.perf_counter()
        try:
            with rng:
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            logger.debug("phase %s: %.3fms", name, dt * 1e3)

    def call(self, name: str, **attrs):
        """The root span of a serving call: opens a call record while a
        profiler records; inside a call already open (a chunked, delegated
        or row-sharded call) a span of that call."""
        if self._open.call is not None:
            return _Range(self, name, attrs, False)
        if not _autograd_profiler._is_profiler_enabled:
            return _NO_SPAN
        return _Range(self, name, attrs, True)

    def span(self, name: str, **attrs):
        """A span of the open call; a no-op outside one."""
        if self._open.call is None:
            return _NO_SPAN
        return _Range(self, name, attrs, False)

    def recording(self) -> bool:
        """Whether a call is being recorded (spans and notes take effect):
        a site computes what it notes only then."""
        return self._open.call is not None

    def note(self, **attrs) -> None:
        """Add ``attrs`` to the innermost open span (nothing outside a
        recorded call)."""
        st = self._open
        if st.call is not None and st.stack:
            st.call.spans[st.stack[-1]].attrs.update(attrs)

    def add(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (one of :data:`COUNTERS`)."""
        self.tally[name] += n

    def counters(self) -> Dict[str, int]:
        """Every counter of the port by name, now (process-wide running
        totals; a call's change is in its :class:`CallRecord`)."""
        return dict(self.tally)

    def calls(self) -> List[CallRecord]:
        """The newest recorded calls (at most ``CALL_RING``), oldest
        first."""
        return list(self._calls)

    def report(self) -> Dict[str, float]:
        out = dict(self.totals)
        logger.info(
            "phases: %s",
            " ".join(f"{k}={v*1e3:.1f}ms" for k, v in sorted(out.items())),
        )
        return out

    def reset(self) -> None:
        """Clear the phase totals and the recorded calls (counters run
        on)."""
        self.totals.clear()
        self.counts.clear()
        self._calls.clear()


# process-wide recorder used by compile_plan, the Engine, the programs, the
# big-clique route and the kernel wrapper
TIMERS = PhaseTimers()


@contextlib.contextmanager
def device_trace(path: str) -> Iterator[None]:
    """``torch.profiler`` trace of the CPU and, where there is one, the
    CUDA device around a block, written to ``path`` as a Chrome trace (open
    it in Perfetto or ``chrome://tracing``).  The program's spans are in
    it, as ``record_function`` ranges, and in ``TIMERS.calls()``."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    prof.export_chrome_trace(path)


def log_compile_stats(plan) -> None:
    """Structured one-line compile log: treewidth, clique states, depth,
    the elimination order that won."""
    st = plan.stats()
    logger.info(
        "compiled plan: vars=%d factors=%d cliques=%d seps=%d treewidth=%d "
        "max_states=%d total_states=%d depth=%d order=%s",
        st["num_vars"], st["num_factors"], st["num_cliques"],
        st["num_separators"], st["treewidth"], st["max_clique_states"],
        st["total_clique_states"], st["tree_depth"], st["order"],
    )
