"""Device milliseconds a traced call spends in the chain program's two
passes: every kernel, set and copy launched from inside its
``chain.forward`` and ``chain.backward`` spans (matched by correlation,
``portbench.trace``), summed over the window and divided by its calls."""

SPANS = ("chain.forward", "chain.backward")


def read(run):
    t = run.trace
    if t is None or not any(s in t.span_device_s for s in SPANS):
        return None
    return 1e3 * sum(t.span_device_s.get(s, 0.0) for s in SPANS) / t.calls
