"""Device milliseconds a traced call spends on an HMM's leaves: every
kernel, set and copy launched from inside the program's ``chain.leaves``
spans (the leaves' evidence folded into the hidden masks before the
passes, their posteriors after), summed over the window and divided by
its calls."""

SPAN = "chain.leaves"


def read(run):
    t = run.trace
    if t is None or SPAN not in t.span_device_s:
        return None
    return 1e3 * t.span_device_s[SPAN] / t.calls
