"""Kernels launched on the device per call in the traced window
(``torch.profiler``; copies and sets between host and device not
counted)."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / t.calls
