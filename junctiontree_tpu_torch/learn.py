"""Maximum-likelihood learning of factor-graph potentials
(counterpart of ``junctiontree_tpu/learn.py``).

Propagation is built from differentiable torch operations, so the
log-partition function is exactly differentiable: grad(logZ) w.r.t. the
per-factor log-potentials equals the model's expected sufficient statistics
(normalized factor marginals).  Maximum-likelihood fitting of an MRF to data
is gradient ascent on

    L(theta) = sum_f <empirical_marginal_f, theta_f> - logZ(theta)

whose gradient is (empirical moments - model moments): moment matching.

logZ comes from the rescaled batch-aware message program
(``executor.BatchedProgramBuilder``) run for its collect and partition steps
only, so no distribute message and no marginal is computed or kept alive for
the backward pass.  On a model with a big clique the program's contractions
go through the factored big-clique contraction, whose
``torch.autograd.Function`` launches the CUDA kernel for the forward value
and for the two weight gradients (``ops/factored_contract.py``).

Parameters live on ``device`` (default CUDA device 0; ``"cpu"`` runs on the
CPU) in ``dtype`` (float32 or float64) across steps; only the returned
arrays and the loss history cross to the host.  The optimizer is Adam
(``torch.optim.Adam``), with the rates of the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .executor import (
    BatchedProgramBuilder,
    evaluate_cliques,
    factor_marginals,
    partition,
    propagate_cliques,
    resolve_device,
)
from .ops.semirings import SUM_PRODUCT
from .schedule import Plan

# the steps of the message program that logZ needs
_LOGZ_STEPS = ("up", "z")


def _place(xs, device, dtype) -> List[torch.Tensor]:
    """Tensors as they are; arrays onto ``device`` (``None``: CUDA device 0)
    in ``dtype``."""
    if all(isinstance(x, torch.Tensor) for x in xs):
        return list(xs)
    dev = resolve_device(device)
    return [
        x if isinstance(x, torch.Tensor)
        else torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        for x in xs
    ]


def empirical_marginals(plan: Plan, data: np.ndarray) -> List[np.ndarray]:
    """Per-factor empirical frequency tables from complete data.

    data: [N, num_vars] int array (columns indexed by interned var id)."""
    N = data.shape[0]
    out = []
    for fvars in plan.factors:
        shape = tuple(plan.sizes[v] for v in fvars)
        if not fvars:
            out.append(np.ones(()))
            continue
        idx = tuple(data[:, v] for v in fvars)
        flat = np.ravel_multi_index(idx, shape)
        counts = np.bincount(flat, minlength=int(np.prod(shape)))
        out.append(counts.reshape(shape) / N)
    return out


def _logz_program(plan: Plan):
    """fn(thetas) -> logZ (a scalar), differentiable in thetas: rescaled
    linear-space propagation (stable at any model size; plain linear Z
    over/underflows float32 beyond ~100 variables)."""
    program = BatchedProgramBuilder(plan, SUM_PRODUCT, observed=[], rescale=True)

    def fn(thetas):
        pots = evaluate_cliques(plan, [torch.exp(t) for t in thetas])
        return program.run(pots, [], kinds=_LOGZ_STEPS)[("z",)][0]

    return fn


def _linear_term(thetas, emp) -> torch.Tensor:
    return sum((m.to(t.dtype) * t).sum() for m, t in zip(emp, thetas))


def log_likelihood(
    plan: Plan,
    thetas: Sequence,
    emp: Sequence,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Average complete-data log-likelihood under log-potentials theta
    (tensors, or arrays that are placed on ``device`` in ``dtype``)."""
    thetas = _place(thetas, device, dtype)
    emp = _place(emp, thetas[0].device if thetas else device, dtype)
    return _linear_term(thetas, emp) - _logz_program(plan)(thetas)


def _init_thetas(plan, init_thetas, device, dtype) -> List[torch.Tensor]:
    """Leaf parameter tensors on the device: zeros, or copies of a warm
    start."""
    if init_thetas is None:
        return [
            torch.zeros(tuple(plan.sizes[v] for v in f), dtype=dtype,
                        device=device, requires_grad=True)
            for f in plan.factors
        ]
    return [
        torch.tensor(np.asarray(t), dtype=dtype, device=device,
                     requires_grad=True)
        for t in init_thetas
    ]


def _adam_ascent(params, neg_loglik, steps, rate, verbose, what) -> List[float]:
    """``steps`` Adam steps on ``neg_loglik()``; the per-step average
    log-likelihoods (taken before each update)."""
    opt = torch.optim.Adam(params, lr=rate)
    history: List[float] = []
    for i in range(steps):
        loss = neg_loglik()
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        history.append(-float(loss.detach()))
        if verbose and i % 20 == 0:
            print(f"step {i}: avg {what} {history[-1]:.6f}")
    return history


def fit_mle(
    plan: Plan,
    data: np.ndarray,
    steps: int = 200,
    learning_rate: float = 0.5,
    init_thetas: Optional[Sequence[np.ndarray]] = None,
    verbose: bool = False,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[List[np.ndarray], List[float]]:
    """Fit factor log-potentials to complete data by gradient ascent.

    Returns (thetas, per-step average log-likelihoods).  Exact moment
    matching: at convergence the model's factor marginals equal the
    empirical tables."""
    device = resolve_device(device)
    emp = _place(empirical_marginals(plan, data), device, dtype)
    thetas = _init_thetas(plan, init_thetas, device, dtype)
    logz = _logz_program(plan)
    history = _adam_ascent(
        thetas, lambda: logz(thetas) - _linear_term(thetas, emp), steps,
        learning_rate * 0.2, verbose, "loglik",
    )
    return [t.detach().cpu().numpy() for t in thetas], history


def model_marginals(
    plan: Plan,
    thetas: Sequence,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> List[np.ndarray]:
    """Normalized per-factor marginals of the model exp(theta)."""
    with torch.no_grad():
        vals = [torch.exp(t) for t in _place(thetas, device, dtype)]
        pots = evaluate_cliques(plan, vals)
        beliefs, _ = propagate_cliques(plan, pots)
        z = partition(plan, beliefs)
        return [(m / z).cpu().numpy() for m in factor_marginals(plan, beliefs)]


# ---------------------------------------------------------------------------
# Incomplete data: masks, marginal likelihood, gradient MLE, and EM.
#
# The whole machinery rides one identity: for p(x) ∝ exp(Σ_f θ_f·φ_f(x)),
#   ∂ logZ(evidence) / ∂ θ_f = E[φ_f | evidence],
# so expected sufficient statistics (the E-step) are one autograd call on the
# batched, rescaled logZ program — no dedicated posterior-moment code path.
# ---------------------------------------------------------------------------


def masks_from_data(
    plan: Plan, data: np.ndarray, missing: int = -1
) -> List[np.ndarray]:
    """Evidence masks for (possibly incomplete) data.

    data: [N, num_vars] int array, columns indexed by interned var id;
    entries equal to ``missing`` mean unobserved.  Returns one [N, size_v]
    float32 mask per var id: one-hot where observed, all-ones where
    missing."""
    N = data.shape[0]
    masks = []
    for v in range(plan.num_vars):
        col = np.asarray(data[:, v])
        m = np.ones((N, plan.sizes[v]), dtype=np.float32)
        obs = col != missing
        if np.any((col[obs] < 0) | (col[obs] >= plan.sizes[v])):
            raise ValueError(f"state out of range for var id {v}")
        m[obs] = 0.0
        m[obs, col[obs]] = 1.0
        masks.append(m)
    return masks


def _obs_logz_program(plan: Plan):
    """fn(thetas, masks) -> logZ(evidence) [B], differentiable in thetas."""
    program = BatchedProgramBuilder(
        plan, SUM_PRODUCT, observed=list(range(plan.num_vars)), rescale=True
    )

    def fn(thetas, masks):
        pots = evaluate_cliques(plan, [torch.exp(t) for t in thetas])
        masks = [m.to(pots[0].dtype) for m in masks]
        return program.run(pots, masks, kinds=_LOGZ_STEPS)[("z",)]

    return fn


def marginal_log_likelihood(
    plan: Plan,
    thetas: Sequence,
    masks: Sequence,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Average observed-data log-likelihood with missing entries:
    mean_b [logZ(evidence_b)] - logZ."""
    thetas = _place(thetas, device, dtype)
    masks = _place(masks, thetas[0].device if thetas else device, dtype)
    return _obs_logz_program(plan)(thetas, masks).mean() - _logz_program(plan)(thetas)


def fit_mle_missing(
    plan: Plan,
    data: np.ndarray,
    steps: int = 200,
    learning_rate: float = 0.1,
    init_thetas: Optional[Sequence[np.ndarray]] = None,
    missing: int = -1,
    verbose: bool = False,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[List[np.ndarray], List[float]]:
    """Gradient MLE with missing data: ascend mean_b logZ(ev_b) - logZ.

    The gradient is E[φ|observed] (averaged over cases) minus the model
    moments — gradient EM.  Returns (thetas, per-step avg marginal log-lik)."""
    device = resolve_device(device)
    masks = _place(masks_from_data(plan, data, missing), device, dtype)
    thetas = _init_thetas(plan, init_thetas, device, dtype)
    obs_logz, logz = _obs_logz_program(plan), _logz_program(plan)
    history = _adam_ascent(
        thetas, lambda: logz(thetas) - obs_logz(thetas, masks).mean(),
        steps, learning_rate, verbose, "marginal loglik",
    )
    return [t.detach().cpu().numpy() for t in thetas], history


def _e_step(obs_logz, values, masks, device, dtype):
    """(logZ(evidence_b) [B], Σ_b E[φ_f | evidence_b] per factor) at the
    parameters ``values``: one forward pass and its gradient."""
    thetas = [
        torch.log(
            torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            .clamp_min(1e-38)
        ).requires_grad_(True)
        for v in values
    ]
    logz = obs_logz(thetas, masks)
    return logz.detach(), torch.autograd.grad(logz.sum(), thetas)


def expected_counts(
    plan: Plan,
    values: Sequence[np.ndarray],
    masks: Sequence,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> List[np.ndarray]:
    """E-step: Σ_b E[φ_f | evidence_b] per factor, via grad of Σ_b logZ_b."""
    masks = _place(masks, device, dtype)
    device = masks[0].device if masks else resolve_device(device)
    _, g = _e_step(_obs_logz_program(plan), values, masks, device, dtype)
    return [c.cpu().numpy() for c in g]


def fit_em(
    plan: Plan,
    data: np.ndarray,
    steps: int = 50,
    child_axes: Optional[Sequence[int]] = None,
    init_values: Optional[Sequence[np.ndarray]] = None,
    smoothing: float = 1e-3,
    missing: int = -1,
    seed: int = 0,
    verbose: bool = False,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[List[np.ndarray], List[float]]:
    """Classical EM for Bayesian networks (CPD factors) with missing data.

    Each factor is a CPD over its variable list; ``child_axes[f]`` is the
    axis (position in ``plan.factors[f]``) of the child variable (default:
    the last axis, the convention of P(child | parents)).  E-step = one
    autograd pass (expected counts); M-step = normalize counts along the
    child axis (closed form, monotone in the smoothed marginal likelihood).
    Returns (values, per-iteration avg marginal log-lik).

    With complete data this reduces to one-shot maximum-likelihood counting."""
    nf = len(plan.factors)
    if child_axes is None:
        child_axes = [len(f) - 1 for f in plan.factors]
    child_axes = list(child_axes)
    if len(child_axes) != nf:
        raise ValueError("child_axes must align with plan.factors")
    device = resolve_device(device)

    rng = np.random.default_rng(seed)
    if init_values is None:
        values = []
        for f, ax in zip(plan.factors, child_axes):
            shape = tuple(plan.sizes[v] for v in f)
            t = rng.random(shape) + 0.5
            values.append(t / t.sum(axis=ax, keepdims=True))
    else:
        values = [np.asarray(v, dtype=np.float64) for v in init_values]

    masks = _place(masks_from_data(plan, data, missing), device, dtype)
    obs_logz = _obs_logz_program(plan)

    history = []
    for it in range(steps):
        logz, counts = _e_step(obs_logz, values, masks, device, dtype)
        # observed-data avg log-likelihood at the *current* parameters
        # (CPDs are normalized, so the free logZ is 0)
        history.append(float(logz.mean()))
        values = []
        for c, ax in zip(counts, child_axes):
            c = c.double().cpu().numpy() + smoothing
            values.append(c / c.sum(axis=ax, keepdims=True))
        if verbose and it % 5 == 0:
            print(f"EM iter {it}: avg marginal loglik {history[-1]:.6f}")
    return values, history
