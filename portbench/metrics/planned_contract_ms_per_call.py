"""Device milliseconds a traced call spends in the general program's
planned contractions: every kernel, set and copy launched from inside its
``route.einsum`` spans (matched by the profiler's correlation of each
launch with its device operation, ``portbench.trace``), summed over the
window and divided by its calls.  Matched by span, not by kernel name, so
it reads whatever implements the contractions."""

from portbench.einsum_roofline import SPAN


def read(run):
    t = run.trace
    if t is None or SPAN not in t.span_device_s:
        return None
    return 1e3 * t.span_device_s[SPAN] / t.calls
