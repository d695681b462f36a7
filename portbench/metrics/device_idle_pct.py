"""Share of the traced window in which nothing ran on the device:
100 x (window - busy) / window, busy being the union of every kernel, copy
and set on the device (``torch.profiler``)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
