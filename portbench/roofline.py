"""The card's published peaks and the operations and bytes of a kernel call.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 989 TFLOP/s on the
tensor cores in bf16, and 3.35 TB/s of HBM.  Every dtype's operations are
divided by the same 989 TFLOP/s, so that no implementation of a float32
contraction, however few tensor-core passes it takes, can read above its
bound.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def k1_call(R1: int, R2: int, C: int, B: int, pot_bytes: int,
            w1_bytes: int, w2_bytes: int, out_bytes: int):
    """(operations, bytes, least seconds, "operations" or "bytes") of one
    contraction out[b, c] = sum pot[r1, r2, c] w1[b, r1] w2[b, r2]: a
    multiply and an add per term, and each operand as handed over read
    once and the output written once."""
    ops = 2 * B * R1 * R2 * C
    nbytes = pot_bytes + w1_bytes + w2_bytes + out_bytes
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return ops, nbytes, max(t_ops, t_bytes), (
        "operations" if t_ops > t_bytes else "bytes")
