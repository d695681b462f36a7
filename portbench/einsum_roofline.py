"""The least time of the general program's planned contractions on the
card.

A planned contraction (``route.einsum`` span of the program) multiplies its
operands and sums onto the output, over ``states`` joint states of the
union of their scopes for each of ``B`` rows: a multiply and an add each,
2 B states operations, at most.  The program pins float32 products at full
precision (TF32 off), so they run on the CUDA cores: 66.9 TFLOP/s on one
NVIDIA H100 SXM (``portbench.chain_roofline``).  It has to read its
operands and write its output once: ``bytes`` (the logical operands, not
the copies an implementation makes), over 3.35 TB/s of HBM.  The bound is
the larger of the two, so it counts the same work whatever implements
the contraction.
"""

from __future__ import annotations

from portbench.chain_roofline import FP32_FLOPS, PEAK_BYTES_PER_S

SPAN = "route.einsum"
ATTRS = ("B", "states", "bytes")


def contraction(B: int, states: int, nbytes: int):
    """(operations, bytes, least seconds, "operations" or "bytes") of one
    planned contraction."""
    ops = 2 * B * states
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return ops, nbytes, max(t_ops, t_bytes), (
        "operations" if t_ops > t_bytes else "bytes")


def span_bound_s(attrs: dict):
    """Least seconds of the contraction a span records, or None where it
    records no shape."""
    if not all(k in attrs for k in ATTRS):
        return None
    return contraction(attrs["B"], attrs["states"], attrs["bytes"])[2]
