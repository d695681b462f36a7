"""Phase timers + structured compile/run logging (SURVEY.md §5 tracing row:
the reference has no instrumentation at all)."""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator

logger = logging.getLogger("junctiontree_tpu_torch")


class PhaseTimers:
    """Accumulates wall-clock per named phase; log with .report()."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            logger.debug("phase %s: %.3fms", name, dt * 1e3)

    def report(self) -> Dict[str, float]:
        out = dict(self.totals)
        logger.info(
            "phases: %s",
            " ".join(f"{k}={v*1e3:.1f}ms" for k, v in sorted(out.items())),
        )
        return out

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


# process-wide timers used by compile_plan and Engine (every compile and
# program build in the package is phased through here)
TIMERS = PhaseTimers()


@contextlib.contextmanager
def device_trace(path: str) -> Iterator[None]:
    """``torch.profiler`` trace of the CPU and, where there is one, the
    CUDA device around a block, written to ``path`` as a Chrome trace (open
    it in Perfetto or ``chrome://tracing``)."""
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
    """Structured one-line compile log: treewidth, clique states, depth."""
    st = plan.stats()
    logger.info(
        "compiled plan: vars=%d factors=%d cliques=%d seps=%d treewidth=%d "
        "max_states=%d total_states=%d depth=%d",
        st["num_vars"], st["num_factors"], st["num_cliques"],
        st["num_separators"], st["treewidth"], st["max_clique_states"],
        st["total_clique_states"], st["tree_depth"],
    )
