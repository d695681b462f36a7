"""Host milliseconds a call spends placing its evidence masks on the
device: the mean over the traced window's calls of their ``serve.masks``
spans (``portbench.spans``)."""

from portbench.spans import window_calls


def read(run):
    calls = window_calls(run)
    if not calls:
        return None
    return 1e3 * sum(s.seconds for c in calls
                     for s in c.named("serve.masks")) / len(calls)
