"""What the program recorded of the traced window's calls
(``junctiontree_tpu_torch.utils.timing.TIMERS``): its spans and its
counters, read after the window.

The harness makes no serving call between the traced window and the
readers, so the window's calls are the newest ``run.calls`` call records.
A program without the recorder (no ``TIMERS.calls``), or one that recorded
fewer calls than the window held, gives None: the reading is left out.
"""

from __future__ import annotations


def recorder():
    """The program's recorder, or None where it has none."""
    from junctiontree_tpu_torch.utils.timing import TIMERS

    return TIMERS if callable(getattr(TIMERS, "calls", None)) else None


def window_calls(run):
    """The call records of the traced window's calls, oldest first, or
    None."""
    rec = recorder()
    if rec is None or run.calls <= 0:
        return None
    calls = rec.calls()
    if len(calls) < run.calls:
        return None
    return calls[-run.calls:]
