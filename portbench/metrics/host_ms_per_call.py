"""Host milliseconds a call spends in the program: the mean over the traced
window's calls of the serving entry point's root span (entry to return,
before the harness's synchronize; ``portbench.spans``)."""

from portbench.spans import window_calls


def read(run):
    calls = window_calls(run)
    if not calls:
        return None
    return 1e3 * sum(c.seconds for c in calls) / len(calls)
