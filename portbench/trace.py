"""What a traced window's ``torch.profiler`` record says.

The window is the span of the ``portbench.call`` ranges the harness opens
around each traced call.  Device activity is every kernel, copy and set on
the device inside it; busy time is the length of their union.  An idle gap
is named by the innermost host operation running at its middle.  A
program span's device time is that of every device operation launched from
inside its ranges: each CUDA API call (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaMemsetAsync``, ...) whose start lies in a range
of the span, and the kernel, copy or set that the profiler correlates
with that call (its correlation id).
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

MARK = "portbench.call"
_NAME = 120  # characters of a kernel name kept in the breakdown
# a CUDA API call, which kineto names after the function
_LAUNCH = re.compile(r"^cu(da)?[A-Z]")


@dataclass
class Trace:
    calls: int
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]          # (name, seconds) per launch
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    # program span name -> device seconds of what its ranges launched (a
    # span that launched nothing on the device is absent)
    span_device_s: Dict[str, float] = field(default_factory=dict)


def _is_device(e) -> bool:
    return "cuda" in str(e.device_type()).lower()


def _is_launch(e) -> bool:
    return not _is_device(e) and bool(_LAUNCH.match(e.name()))


def _is_annotation(e) -> bool:
    kind = str(getattr(e, "activity_type", lambda: "")()).lower()
    return (e.name() == MARK or "annotation" in kind
            or bool(getattr(e, "is_user_annotation", lambda: False)()))


def _union(intervals):
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def read(prof, top: int = 10) -> Trace:
    """The traced window of a finished ``torch.profiler.profile``."""
    return read_events(prof.profiler.kineto_results.events(), top)


def read_events(events, top: int = 10) -> Trace:
    """The traced window of a profiler's kineto events."""
    marks = [e for e in events if e.name() == MARK and not _is_device(e)]
    if not marks:
        raise ValueError("the trace holds no traced call")
    w0 = min(e.start_ns() for e in marks)
    w1 = max(e.end_ns() for e in marks)
    dev, host, spans, launches = [], [], [], []
    for e in events:
        if _is_annotation(e):
            if (not _is_device(e) and e.name() != MARK
                    and w0 <= e.start_ns() and e.end_ns() <= w1):
                spans.append((e.name(), e.start_ns(), e.end_ns()))
            continue
        if _is_launch(e):
            launches.append((e.start_ns(), e.correlation_id()))
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        if _is_device(e):
            dev.append((e.name(), s, t, e.correlation_id()))
        else:
            host.append((e.name(), s, t))
    merged = _union((s, t) for _, s, t, _ in dev)
    busy = sum(t - s for s, t in merged)
    kernels = [(n, (t - s) / 1e9) for n, s, t, _ in dev
               if not n.lower().startswith(("memcpy", "memset"))]
    by_name: Dict[str, float] = {}
    for n, s, t, _ in dev:
        by_name[n[:_NAME]] = by_name.get(n[:_NAME], 0.0) + (t - s) / 1e9
    # idle gaps inside the window, each named by the innermost host
    # operation running at its middle
    edges = [w0] + [x for st in merged for x in st] + [w1]
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = "host outside any operation"
        i = bisect.bisect_right(starts, mid)
        for n, s, t in reversed(host[max(0, i - 256):i]):
            if t >= mid:
                label = n
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    return Trace(
        calls=len(marks), window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        kernels=kernels,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
        span_device_s=_span_device_s(spans, launches, dev))


def _span_device_s(spans, launches, dev) -> Dict[str, float]:
    """Device seconds launched from inside each span name's ranges, matched
    range -> runtime call (by its start) -> device operation (by the
    correlation id they share); a launch inside nested ranges counts once
    for each name."""
    launches.sort()
    starts = [s for s, _ in launches]
    ids: Dict[str, set] = {}
    for name, s, t in spans:
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, t)
        ids.setdefault(name, set()).update(c for _, c in launches[lo:hi])
    seconds = {}
    for name, own in ids.items():
        total = sum(t - s for _, s, t, c in dev if c in own)
        if total > 0:
            seconds[name] = total / 1e9
    return seconds
