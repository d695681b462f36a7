"""``Engine.posterior_batch`` on a lattice model, judged against the
lattice's transfer sweep (``portbench.lattice_reference``) in float64.

The engine, the call, the answers taken and the comparison are those of
``surfaces/posterior_batch.py``; only the reference differs, because the
shared reference's min-weight tree of a 20 x 20 lattice holds cliques of
2^32 states.  The control ("lattice_tf32") is the same sweep in float32
with both operands of every multiply rounded to TF32, the precision below a
float32 configuration's.
"""

from __future__ import annotations

import os

import torch

from portbench import core
from portbench.lattice_reference import reference

_PLAIN = core.load_module(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "surfaces", "posterior_batch")

batches = _PLAIN.batches
engine = _PLAIN.engine
call = _PLAIN.call
take = _PLAIN.take
compare = _PLAIN.compare


def judge(got, masks, factors, sizes, values, device, limits):
    return compare(got, reference(factors, sizes, values, masks, device),
                   limits)


def control(kind, factors, sizes, values, masks, device):
    """The control's answers for the rows of ``masks``."""
    if kind == "lattice_tf32":
        return reference(factors, sizes, values, masks, device,
                         torch.float32, tf32=True)
    raise ValueError(f"no control {kind!r} for lattice posteriors")
