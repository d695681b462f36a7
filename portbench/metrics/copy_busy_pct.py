"""Device time of the kernels whose names hold "copy" (layout copies:
operands made contiguous, permuted, expanded) as a share of the device's
busy time in the traced window."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    copies = sum(s for n, s in t.kernels if "copy" in n.lower())
    return 100.0 * copies / t.busy_s
