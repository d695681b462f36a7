"""Evidence rows answered in the window over the window's length: from the
first call's start to the end of the last call (host clock, each call
ending in a device synchronize)."""


def read(run):
    return run.rows / run.window_s if run.window_s > 0 else None
