"""Device milliseconds a traced call spends in the tree-MAP collect: every
kernel, set and copy launched from inside the program's ``map.collect``
spans (matched by the profiler's correlation of each launch with its device
operation, ``portbench.trace``), summed over the window and divided by its
calls.  Matched by span, not by kernel name, so it reads whatever
implements the collect."""

SPAN = "map.collect"


def read(run):
    t = run.trace
    if t is None or SPAN not in t.span_device_s:
        return None
    return 1e3 * t.span_device_s[SPAN] / t.calls
