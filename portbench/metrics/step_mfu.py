"""The whole step's share of the card's peak while the device works: the
operations of exact inference on the benchmark's own junction tree
(``portbench.reference.Reference.operations``: a multiply and an add per
clique state and row for every message, marginal and partition) for every
traced call, over the device's busy seconds in the traced window times 989
TFLOP/s.  Device time, not the window: the host's share of the step moves
``device_idle_pct``, this moves with the work the device does per row."""

from portbench.roofline import PEAK_FLOPS


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.step_operations:
        return None
    return 100.0 * run.step_operations * t.calls / (t.busy_s * PEAK_FLOPS)
