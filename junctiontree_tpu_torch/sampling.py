"""Exact posterior sampling from a junction tree
(counterpart of ``junctiontree_tpu/sampling.py``).

Forward-filtering backward-sampling: after the collect pass, the root clique
belief is the unnormalized joint over its variables; sample the root clique
configuration from it, then walk the tree root->leaves sampling each clique's
non-separator variables conditionally on its already-sampled separator
assignment.  Every draw is an independent exact sample from the (evidence-
conditioned) distribution.

The sampler is batched over the samples: the assignment is one
``[N, num_vars]`` tensor, and per clique the belief is reshaped to
``[sep_states, rest_states]``, the sampled separator assignments ravel to a
row index per sample, one gather picks the rows and one categorical draw
(from a ``torch.Generator`` on the beliefs' device) fills the clique's
remaining variables.  The random streams are torch's, not the JAX package's:
the two agree in distribution, not draw for draw.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .ops.semirings import SUM_PRODUCT, Semiring
from .schedule import Plan

_NEG_INF = -1e30


def _log(x: torch.Tensor) -> torch.Tensor:
    tiny = 1e-300 if x.dtype == torch.float64 else 1e-38
    return torch.where(x > 0, torch.log(x.clamp_min(tiny)), _NEG_INF)


def _generator(key, device) -> torch.Generator:
    """``key`` as a generator on ``device``: an int seeds a new one."""
    if isinstance(key, torch.Generator):
        if key.device.type != torch.device(device).type:
            raise ValueError(
                f"the generator is on {key.device}, the beliefs on {device}"
            )
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def make_sampler(plan: Plan, semiring: Semiring = SUM_PRODUCT):
    """Build ``fn(clique_beliefs, generator, num_samples) -> assignments
    [num_samples, num_vars] int32``.

    ``clique_beliefs`` are consistent post-propagation beliefs (linear or
    log space per ``semiring``); ``generator`` lies on their device."""
    tree = plan.tree
    cvars = plan.clique_vars
    svars = plan.sep_vars

    # layout per clique: separator-to-parent vars first
    layouts = []
    for c in range(tree.num_cliques):
        sep = list(svars[tree.parent_sep[c]]) if c != tree.root else []
        rest = [v for v in cvars[c] if v not in sep]
        perm = [cvars[c].index(v) for v in sep + rest]
        sep_shape = tuple(plan.sizes[v] for v in sep)
        rest_shape = tuple(plan.sizes[v] for v in rest)
        layouts.append((sep, rest, perm, sep_shape, rest_shape))

    def fn(clique_beliefs: Sequence[torch.Tensor], generator, num_samples: int):
        device = clique_beliefs[0].device
        N = int(num_samples)
        assign = torch.zeros((N, plan.num_vars), dtype=torch.int64, device=device)
        for c in tree.topo_order:
            sep, rest, perm, sep_shape, rest_shape = layouts[c]
            if not rest:
                continue  # all clique vars already fixed by the separator
            b = clique_beliefs[c]
            logb = b if semiring.is_log else _log(b)
            logb = logb.permute(perm).reshape(
                (int(np.prod(sep_shape)) if sep_shape else 1, -1)
            )
            if sep:
                sep_idx = torch.zeros((N,), dtype=torch.int64, device=device)
                for v, n in zip(sep, sep_shape):
                    sep_idx = sep_idx * n + assign[:, v]
                logits = logb[sep_idx]
            else:
                logits = logb  # one row: every sample shares the root's table
            # a row's maximum comes off before exp: the weights stay finite
            # and the largest is 1, so every row has a positive state
            w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
            if sep:
                draw = torch.multinomial(w, 1, generator=generator)[:, 0]
            else:
                draw = torch.multinomial(
                    w[0], N, replacement=True, generator=generator)
            # unravel the drawn rest-state into per-var values
            extent = int(np.prod(rest_shape))
            for v, n in zip(rest, rest_shape):
                extent //= n
                assign[:, v] = (draw // extent) % n
        return assign.to(torch.int32)

    return fn


def sample(
    plan: Plan,
    clique_beliefs: Sequence[torch.Tensor],
    key,
    num_samples: int,
    semiring: Semiring = SUM_PRODUCT,
) -> torch.Tensor:
    """Draw ``num_samples`` exact samples; returns [num_samples, num_vars]
    int32 on the beliefs' device (columns indexed by interned var id).
    ``key`` is a ``torch.Generator`` on that device, or an int seed."""
    gen = _generator(key, clique_beliefs[0].device)
    return make_sampler(plan, semiring)(clique_beliefs, gen, num_samples)


def engine_sample(engine, key, num_samples: int, evidence=None) -> np.ndarray:
    """Posterior samples from an Engine with set potentials, drawn on the
    engine's device.

    Applies evidence masks, propagates once, then draws ``num_samples``
    exact samples.  ``key``: a ``torch.Generator`` on the engine's device or
    an int seed.  Returns [num_samples, num_vars] int32."""
    from .executor import apply_masks, evidence_to_masks, propagate_cliques

    plan = engine.plan
    pots = engine._require_pots()
    masks = evidence_to_masks(plan, evidence or {}, engine.semiring)
    mpots = apply_masks(
        plan, pots, [engine._place(m) for m in masks], engine.semiring
    )
    beliefs, _ = propagate_cliques(plan, mpots, engine.semiring)
    return sample(plan, beliefs, key, num_samples, engine.semiring).cpu().numpy()
