"""GiB of batch-by-state tensors a call writes: the mean over the traced
window's calls of each call's change in the program's counters
``route.materialized_bytes`` (the big-clique route's expanded ``w2`` and
any copy the kernel wrapper makes of its weights) and
``map.materialized_bytes`` (the tree-MAP program's [B, clique] tensors and
permuted copies), over 2^30 (``portbench.spans``)."""

from portbench.spans import window_calls

KEYS = ("route.materialized_bytes", "map.materialized_bytes")


def read(run):
    calls = window_calls(run)
    if not calls or not all(k in c.counters for c in calls for k in KEYS):
        return None
    return sum(c.counters[k] for c in calls for k in KEYS) / len(calls) / 2**30
