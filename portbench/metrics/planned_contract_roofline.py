"""The general program's planned contractions' share of their roofline in
the traced window: the sum over the window's ``route.einsum`` spans of each
contraction's least time (``portbench.einsum_roofline``: its logical shape
as the span records it, FP32 on the CUDA cores or HBM, whichever bounds
it) over the device time of what those spans launched.  None where the
program recorded no such span or no shape on one."""

from portbench.einsum_roofline import SPAN, span_bound_s
from portbench.spans import window_calls


def read(run):
    t, calls = run.trace, window_calls(run)
    if t is None or not calls or SPAN not in t.span_device_s:
        return None
    bounds = [span_bound_s(s.attrs) for c in calls for s in c.named(SPAN)]
    if not bounds or None in bounds:
        return None
    return 100.0 * sum(bounds) / t.span_device_s[SPAN]
