"""The 95th percentile (nearest rank) of every call's latency in the
window, host clock from the call to the device synchronize that ends it."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
