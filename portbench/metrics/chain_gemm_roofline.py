"""The chain program's matrix products' share of their roofline in the
traced window: the least time of every product the window's calls
launched (``portbench.chain_roofline``: FP32 on the CUDA cores or HBM,
whichever bounds it; shapes from the ``chain.forward``, ``chain.backward``
and ``chain.leaves`` spans) over the device time of the window's kernels
whose names hold "gemm".  None where the program recorded no such span."""

from portbench.chain_roofline import SPANS, span_bound_s
from portbench.spans import window_calls


def read(run):
    t, calls = run.trace, window_calls(run)
    if t is None or not calls:
        return None
    spans = [s for c in calls for s in c.spans if s.name in SPANS]
    gemm_s = sum(s for n, s in t.kernels if "gemm" in n.lower())
    if not spans or gemm_s <= 0:
        return None
    return 100.0 * sum(span_bound_s(s.attrs) for s in spans) / gemm_s
