"""The least time of the chain program's matrix products on the card.

The program pins float32 products at full precision (TF32 off), so they
run on the CUDA cores: one NVIDIA H100 SXM has 132 SMs of 128 float32
lanes, a fused multiply-add (2 operations) a lane a cycle at 1.98 GHz,
66.9 TFLOP/s; and 3.35 TB/s of HBM (NVIDIA's data sheet).  A product
[b, k] x [k, n] takes 2 b k n operations and, each operand read once and
the output written once, 4 (b k + k n + b n) bytes.

The products a call launched are the ``products`` attribute of the
program's ``chain.forward``, ``chain.backward`` and ``chain.leaves`` spans:
rows of [count, b, k, n].
"""

from __future__ import annotations

FP32_FLOPS = 132 * 128 * 2 * 1.98e9
PEAK_BYTES_PER_S = 3.35e12
SPANS = ("chain.forward", "chain.backward", "chain.leaves")


def product(b: int, k: int, n: int):
    """(operations, bytes, least seconds, "operations" or "bytes") of one
    float32 product [b, k] x [k, n]."""
    ops = 2 * b * k * n
    nbytes = 4 * (b * k + k * n + b * n)
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return ops, nbytes, max(t_ops, t_bytes), (
        "operations" if t_ops > t_bytes else "bytes")


def span_bound_s(attrs: dict) -> float:
    """Least seconds of the products one span launched."""
    return sum(count * product(b, k, n)[2]
               for count, b, k, n in attrs.get("products", ()))
