"""The chain program's step (``ops.chain_step``: the library's product,
then the row pass, which is the row kernel ``csrc/chain_step.cu`` in
float32 on the card and its plain version ``reference_rows`` elsewhere)
against the plain rescaled step (``scan_executor._rescaled_step``) and the
functional passes.

On the CPU (tier 1): the steps, which run the plain row pass there and
repeat the kernel's arithmetic (the row maximum, the clamp, the divide,
the next product's mask multiply and the backward step's posterior), are
held to the plain step; the chain program's in-place passes to its
functional ones (a gradient through ``A``) and the HMM program to the
general program, on random chains and the Li-Stephens model, impossible
rows included; the engagement rule, the CPU's plain row passes, the
functional path's bypass of the steps and the ``chain_step.launches``
counter are checked as they stand.

On the card (marked ``cuda``, skipped elsewhere): the steps against the
plain row pass in float32 and float64 on the same inputs, forward and
backward, K = 2, 37, 500 and 1000, B from 1 to 16,384, all-zero rows; and
the HMM program at the benchmark cell's shape against the plain float64
Li-Stephens recursion.  Imports no JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_chain_step.py
"""

import numpy as np
import pytest
import torch

import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.models import chain_bn_model
from junctiontree_tpu_torch.models.hmm import li_stephens_model, typed_sites
from junctiontree_tpu_torch.ops import chain_step
from junctiontree_tpu_torch.scan_executor import (
    ChainLayout,
    _rescaled_step,
    chain_logz_program,
    chain_posterior_program,
)
from junctiontree_tpu_torch.utils.timing import TIMERS

from .lshmm_reference import forward_backward

LAUNCHES = "chain_step.launches"


def _launches(fn):
    before = TIMERS.counters()[LAUNCHES]
    out = fn()
    return out, TIMERS.counters()[LAUNCHES] - before


def _chain(K, B, m, seed, dtype=torch.float64, zero_rows=(0,)):
    """A random chain of m steps: transitions [m, K, K] in [0, 1) (some
    exact zeros), masks [m + 1, B, K] in [0, 1); the rows ``zero_rows``
    impossible (their mask at position 1 all zero)."""
    g = torch.Generator().manual_seed(seed)
    A = torch.rand((m, K, K), generator=g, dtype=dtype)
    A[A < 0.05] = 0.0
    M = torch.rand((m + 1, B, K), generator=g, dtype=dtype)
    for r in zero_rows:
        M[min(1, m), r] = 0.0
    return A, M


def _layout(K, m):
    """A chain of m + 1 variables of K states, its cliques in order."""
    return ChainLayout(list(range(m + 1)), list(range(m)), [False] * m, K)


# ------------------------------------------------------------ CPU: plain


@pytest.mark.parametrize("K", [2, 37, 500])
def test_reference_steps_equal_the_plain_step(K):
    """One forward step through the plain row pass as ``_rescaled_step`` of
    the masked messages times the next mask, bit for bit (the last step's
    without it); one backward step's M_k ⊙ G_k likewise, and its posterior
    as the plain pass's ``F * M * G`` over its floored row sum; zero rows
    give zeros and the floor."""
    B = 9
    A, M = _chain(K, B, 2, seed=K, dtype=torch.float32, zero_rows=(0, 4))
    F, G = M[0].clone() + 0.5, M[2].clone()
    out, scale = torch.empty((B, K)), torch.empty((B, 1))
    chain_step.forward_step(F * M[1], A[0], M[2], out, scale)
    want, s = _rescaled_step(F * M[1], A[0])
    assert torch.equal(out, want * M[2]) and torch.equal(scale, s)
    assert not out[0].any() and not out[4].any()
    assert float(scale[0]) == pytest.approx(1e-38, rel=1e-6)
    chain_step.forward_step(M[1], A[0], None, out, scale)
    assert torch.equal(out, _rescaled_step(M[1], A[0])[0])

    post = F * M[0]
    chain_step.backward_step(M[1] * G, A[1], M[0], out, post)
    g, _ = _rescaled_step(M[1] * G, A[1].t())
    p = F * M[0] * g
    assert torch.equal(out, M[0] * g)
    torch.testing.assert_close(
        post, p / p.sum(dim=-1, keepdim=True).clamp_min(1e-38),
        rtol=1e-6, atol=0)
    assert not post[0].any() and not post[4].any()
    chain_step.backward_step(M[1], A[1], None, out, F * M[0])
    assert torch.equal(out, M[1] @ A[1].t())


@pytest.mark.parametrize("backward", [False, True])
def test_reference_rows_without_a_mask(backward):
    """Without a mask the forward row pass leaves y / s, the backward one
    leaves the product as it is and writes only the posterior; a step on
    the CPU launches no kernel."""
    g = torch.Generator().manual_seed(7)
    A, x, post = (torch.rand(s, generator=g) for s in ((6, 6), (3, 6),
                                                       (3, 6)))
    y = x @ (A.t() if backward else A)
    out = torch.empty_like(x)

    def step():
        if backward:
            p = post.clone()
            chain_step.backward_step(x, A, None, out, p)
            return p
        chain_step.forward_step(x, A, None, out)

    p, n = _launches(step)
    assert n == 0
    if backward:
        assert torch.equal(out, y)
        want = post * (y / y.amax(dim=-1, keepdim=True))
        torch.testing.assert_close(
            p, want / want.sum(dim=-1, keepdim=True), rtol=1e-6, atol=0)
    else:
        assert torch.equal(out, y / y.amax(dim=-1, keepdim=True))


@pytest.mark.parametrize("m", [1, 2, 7])
@pytest.mark.parametrize("K", [2, 37, 500])
def test_program_through_the_reference_equals_the_plain_passes(K, m):
    """The chain program's in-place passes (every step through
    ``chain_step``: forward, backward with G in two buffers, each
    position's posterior written as the pass goes, the last position's
    after it) against its functional passes (a gradient through ``A``):
    posteriors and logZ within float64 rounding, impossible rows zero with
    logZ = -inf."""
    B = 5 if K == 500 else 11
    A, M = _chain(K, B, m, seed=10 * K + m, zero_rows=(0, 3))
    lay = _layout(K, m)
    Ag = A.clone().requires_grad_()
    plain_post, plain_z = (t.detach() for t in chain_posterior_program(
        None, lay)(Ag, M))
    post, z = chain_posterior_program(None, lay)(A, M.clone())
    zf = chain_logz_program(None, lay)(A, M)
    assert not post.requires_grad and not z.requires_grad
    torch.testing.assert_close(post, plain_post, rtol=0, atol=1e-12)
    torch.testing.assert_close(z, plain_z, rtol=1e-12, atol=0)
    torch.testing.assert_close(zf, plain_z, rtol=1e-12, atol=0)
    for r in (0, 3):
        assert z[r] == -float("inf") and not post[:, r].any()
    assert torch.isfinite(z[[1, 2, 4]]).all() and not post.isnan().any()


@pytest.mark.parametrize("typed_every", [1, 10])
def test_hmm_program_through_the_reference(typed_every):
    """The HMM program (leaves folded into the masks, the chain's passes
    through ``chain_step``, the leaves' posteriors) against the general
    program, in float64 on the Li-Stephens model."""
    K, M, B = 40, 21, 6
    factors, sizes, values = li_stephens_model(K, M, seed=3)
    eng = jt.create_junction_tree(factors, sizes).engine(
        device="cpu", dtype=torch.float64).set_potentials(values)
    rng = np.random.default_rng(typed_every)
    masks = {}
    for y in typed_sites(M, typed_every):
        mk = np.zeros((B, 2))
        mk[np.arange(B), rng.integers(2, size=B)] = 1.0
        masks[y] = mk
    masks["y0"][0] = 0.0
    plain, plain_z = eng.posterior_batch(masks, mode="general")
    post, z = eng.posterior_batch(masks)
    assert ("hmm",) in eng._programs
    torch.testing.assert_close(z, plain_z, rtol=1e-12, atol=0)
    assert z[0] == -float("inf")
    for v in range(len(post)):
        torch.testing.assert_close(post[v], plain[v], rtol=0, atol=1e-12)
        assert not post[v][0].any()


# ------------------------------------------------------ CPU: engagement


@pytest.mark.parametrize("dtype,device,card,want", [
    (torch.float32, "cuda", 500, True),
    (torch.float32, "cuda:1", 2, True),
    (torch.float32, "cuda", 1024, True),
    (torch.float32, "cuda", 1025, False),
    (torch.float64, "cuda", 500, False),
    (torch.bfloat16, "cuda", 500, False),
    (torch.float16, "cuda", 500, False),
    (torch.float32, "cpu", 500, False),
    (torch.float32, "meta", 500, False),
])
def test_engagement_rule(dtype, device, card, want):
    assert chain_step.engages(dtype, device, card) is want


@pytest.mark.parametrize("card,want", [(1, 256), (2, 256), (256, 256),
                                       (257, 512), (500, 512), (512, 512),
                                       (513, 1024), (1000, 1024)])
def test_block_width(card, want):
    assert chain_step.width(card) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_chains_keep_the_plain_steps(monkeypatch, dtype):
    """On the CPU the uniform chain's and the HMM's programs run the plain
    row pass 2m times a call (m steps each way) and launch no kernel, in
    float32 and float64."""
    passes, plain = [], chain_step.reference_rows
    monkeypatch.setattr(chain_step, "reference_rows",
                        lambda *a, **k: passes.append(1) or plain(*a, **k))
    for model, ev, program in (
            (chain_bn_model(6, card=3, seed=1),
             {"x2": np.eye(3)[[0, 1, 2, 1]]}, "chain"),
            (li_stephens_model(8, 6, seed=1), {"y1": np.eye(2)[[0, 1, 1]]},
             "hmm")):
        factors, sizes, values = model
        eng = jt.create_junction_tree(factors, sizes).engine(
            device="cpu", dtype=dtype).set_potentials(values)
        del passes[:]
        _, n = _launches(lambda: eng.posterior_batch(ev))
        assert (program,) in eng._programs
        assert n == 0 and len(passes) == 2 * 5


def test_gradient_keeps_the_plain_steps(monkeypatch):
    """Under a gradient through A the steps are functional: the program
    never calls ``forward_step`` or ``backward_step``, and its gradient
    equals that of the unscaled forward recursion; without the gradient
    the same call runs m steps each way."""
    K, B, m = 4, 6, 5
    A, M = _chain(K, B, m, seed=5)
    lay = _layout(K, m)
    calls = []
    for name in ("forward_step", "backward_step"):
        real = getattr(chain_step, name)
        monkeypatch.setattr(chain_step, name, lambda *a, real=real, name=name:
                            calls.append(name) or real(*a))
    Ag = A.clone().requires_grad_(True)
    chain_logz_program(None, lay)(Ag, M)[1:].sum().backward()
    post, _ = chain_posterior_program(None, lay)(A.clone().requires_grad_(),
                                                 M)
    assert not calls and post.requires_grad
    with torch.no_grad():
        chain_posterior_program(None, lay)(Ag, M.clone())
    assert calls == ["forward_step"] * m + ["backward_step"] * m
    # the unscaled recursion over the possible rows: logZ = log 1^T ...
    A2 = A.clone().requires_grad_(True)
    F = torch.ones((B - 1, K), dtype=A.dtype)
    for k in range(m):
        F = (F * M[k, 1:]) @ A2[k]
    torch.log((F * M[m, 1:]).sum(dim=-1)).sum().backward()
    torch.testing.assert_close(Ag.grad, A2.grad, rtol=1e-10, atol=1e-12)


def test_counters_table_reports_the_launches():
    table = TIMERS.counters()
    assert LAUNCHES in table and "chain.fused_steps" not in table


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _card_inputs(K, B, dev, seed):
    """A row-stochastic A, masks and messages in [0, 1) with a few exact
    zeros; rows 0 and B // 2 of the masks all zero."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.rand((K, K), generator=g, device=dev)
    A = A / A.sum(dim=1, keepdim=True)
    x, m, mpost, post = (torch.rand((B, K), generator=g, device=dev)
                         for _ in range(4))
    for t in (m, mpost):
        t[t < 0.02] = 0.0
        t[0] = 0.0
        t[B // 2] = 0.0
    return A, x, m, mpost, post


def _tol(K, want):
    """The kernel and a plain version each sum K non-negative products in
    float32, so each is within K u of the exact value relatively (u =
    2^-24); the divides and the posterior's products and sum add at most
    2K u more.  Four times K u over the largest magnitude covers both."""
    return 4 * K * 2.0**-24 * float(want.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 1000, 16384])
@pytest.mark.parametrize("K", [2, 37, 500, 1000])
def test_kernel_equals_plain(cuda, K, B):
    """Forward and backward steps (the library's product, then the row
    kernel), with and without the next mask, against the plain row pass in
    float32 (within twice the rounding bound: both round) and in float64 on
    the same inputs (within the bound); zero rows exactly zero, with the
    floor as their scale; without a mask the backward leaves the product;
    no NaN."""
    A, x, m, mpost, post0 = _card_inputs(K, B, cuda, seed=K * 7 + B)
    xm, fm = x * m, post0 * mpost  # the operand; F_k ⊙ M_k
    launches = TIMERS.counters()[LAUNCHES]
    for last in (False, True):
        mn = None if last else mpost
        out, scale = torch.empty_like(m), torch.empty((B, 1), device=cuda)
        chain_step.forward_step(xm, A, mn, out, scale)
        g, post = torch.empty_like(m), fm.clone()
        chain_step.backward_step(xm, A, mn, g, post)
        torch.cuda.synchronize()
        for dt, k in ((torch.float32, 2), (torch.float64, 1)):
            Ad, xd, fd = (t.to(dt) for t in (A, xm, fm))
            md = None if last else mpost.to(dt)
            y = xd @ Ad
            s = torch.empty((B, 1), dtype=dt, device=cuda)
            chain_step.reference_rows(y, md, scale=s)
            assert (out.to(dt) - y).abs().max() <= k * _tol(K, y)
            assert ((scale.to(dt) - s).abs()
                    <= k * 4 * K * 2.0**-24 * s).all()
            y, p = xd @ Ad.t(), fd.clone()
            chain_step.reference_rows(y, md, post=p)
            assert (g.to(dt) - y).abs().max() <= k * _tol(K, y)
            assert (post.to(dt) - p).abs().max() <= k * _tol(K, p)
        for r in {0, B // 2}:
            assert not out[r].any() and not g[r].any()
            assert float(scale[r]) == pytest.approx(1e-38, rel=1e-6)
            assert not post[r].any()
        assert not any(t.isnan().any() for t in (out, scale, g, post))
    assert TIMERS.counters()[LAUNCHES] - launches == 4


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    A, x, m, mpost, post = _card_inputs(8, 4, cuda, seed=1)
    with pytest.raises(TypeError):
        chain_step.rows(x.double(), m.double())
    with pytest.raises(ValueError):
        chain_step.rows(x.t(), m)
    with pytest.raises(ValueError):
        chain_step.rows(torch.empty((8, 8), device=cuda).t(), None)
    with pytest.raises(ValueError):
        chain_step.rows(x, m, scale=torch.empty(5, device=cuda))
    big = torch.ones((4, 1025), device=cuda)
    with pytest.raises(ValueError):
        chain_step.rows(big, None)


@pytest.mark.cuda
def test_hmm_program_at_the_cell_shape(cuda):
    """The benchmark cell's shape: the Li-Stephens model with K = 500
    templates and 256 sites, B = 16,384 targets, one site in ten typed
    (alleles drawn uniformly), row 0 impossible, float32 on the card.  510
    row-kernel launches a call; against the plain float64 Li-Stephens recursion on
    257 rows (row 0 and 256 more), within the cell's limits: posteriors
    1e-3, logZ 5e-3, no bad row."""
    K, M, B = 500, 256, 16384
    factors, sizes, values = li_stephens_model(K, M, seed=0)
    eng = jt.create_junction_tree(factors, sizes).engine(
        device=cuda, dtype=torch.float32).set_potentials(values)
    rng = np.random.default_rng(12345)
    typed = typed_sites(M, 10)
    masks = {}
    for y in typed:
        mk = np.zeros((B, 2), dtype=np.float32)
        mk[np.arange(B), rng.integers(2, size=B)] = 1.0
        masks[y] = mk
    masks["y0"][0] = 0.0
    eng.posterior_batch(masks)
    before = TIMERS.counters()
    post, logz = eng.posterior_batch(masks)
    torch.cuda.synchronize()
    after = TIMERS.counters()
    assert after[LAUNCHES] - before[LAUNCHES] == 2 * (M - 1)
    rows = np.concatenate([[0], rng.choice(np.arange(1, B), 256,
                                           replace=False)])
    # the recursion in float64 on the host, from the generator's prior,
    # stay probabilities and emissions
    prior = torch.as_tensor(values[0])
    stay = torch.as_tensor([v[0, 0] - v[0, 1] for f, v in zip(factors, values)
                            if len(f) == 2 and f[1].startswith("x")])
    emit = torch.as_tensor(np.stack([v for f, v in zip(factors, values)
                                     if len(f) == 2 and f[1].startswith("y")]))
    obs = {int(y[1:]): torch.as_tensor(mk[rows], dtype=torch.float64)
           for y, mk in masks.items()}
    hidden, allele, ref_z = forward_backward(prior, stay, emit, obs,
                                             len(rows))
    idx = torch.as_tensor(rows, device=cuda)
    ids = eng.plan.table.id_of
    post_err = 0.0
    for m in range(M):
        for label, ref in ((f"x{m}", hidden[m]), (f"y{m}", allele[m])):
            got = post[ids(label)].index_select(0, idx).double().cpu()
            post_err = max(post_err, float((got - ref).abs().max()))
            assert not got.isnan().any()
    z = logz.index_select(0, idx).double().cpu()
    assert z[0] == -float("inf") and ref_z[0] == -float("inf")
    assert torch.isfinite(z[1:]).all()
    logz_err = float((z[1:] - ref_z[1:]).abs().max())
    assert post_err <= 1e-3 and logz_err <= 5e-3, (post_err, logz_err)
