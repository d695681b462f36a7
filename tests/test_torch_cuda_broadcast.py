"""Card tests of the big-clique kernel's broadcast read of ``w2``: the
route's view [B, R2g, rep] of the group weights, read by the float32
tensor-core kernel without the [B, R2] copy.  They need an NVIDIA GPU and
skip elsewhere.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_broadcast.py
"""

import numpy as np
import pytest
import torch

import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS

BROADCAST = "factored_masked_contract.broadcast"
MATERIALIZED = "route.materialized_bytes"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, R1, R2g, rep, C, B, seed):
    """pot [R1, R2g * rep, C] and w1 on the card, and the view of the group
    weights g [B, R2g] over ``rep``, with a row of zeros, a row at the
    serving floor 1e-38 and a row whose groups mix both with ordinary
    values."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pot = torch.rand((R1, R2g * rep, C), generator=g, device=dev)
    w1 = torch.rand((B, R1), generator=g, device=dev)
    w2g = torch.rand((B, R2g), generator=g, device=dev)
    w2g[0] = 0.0
    w2g[1] = 1e-38
    w2g[2, ::2] = 0.0
    w2g[2, 1::4] = 1e-38
    return pot, w1, w2g[:, :, None].expand(B, R2g, rep)


def _counters():
    c = TIMERS.counters()
    return c[BROADCAST], c[MATERIALIZED]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize(
    "R1,R2g,rep,C,B",
    [(64, 64, 32, 2, 4096), (64, 64, 64, 1, 4096),   # the cell's shapes
     (64, 64, 32, 2, 1000), (64, 64, 64, 1, 4097),   # ragged B
     (64, 1, 128, 2, 4096), (64, 16, 256, 1, 1000),  # wider groups
     (40, 2, 32, 4, 4097), (64, 8, 64, 8, 300),
     (3, 4, 32, 48, 130), (2, 1, 64, 300, 130)],     # the "c" tiling
)
def test_broadcast_read_is_bitwise_the_materialised(cuda, R1, R2g, rep, C, B,
                                                    precision):
    """The broadcast read gives the same bits as the same call on the
    expanded operand, in six passes and in one, at the cell's shapes, with
    ragged B, the cluster split of B = 4096, the "c" tiling, and rows of
    zeros and at 1e-38; the view is counted as a broadcast launch and
    copies nothing, the expanded operand the other way round."""
    pot, w1, view = _case(cuda, R1, R2g, rep, C, B, R1 + R2g + rep + C + B)
    flat = view.reshape(B, -1).contiguous()
    b0, m0 = _counters()
    got = fc.factored_masked_contract(pot, w1, view, precision=precision)
    b1, m1 = _counters()
    want = fc.factored_masked_contract(pot, w1, flat, precision=precision)
    b2, m2 = _counters()
    torch.cuda.synchronize()
    assert (b1 - b0, m1 - m0) == (1, 0)
    assert (b2 - b1, m2 - m1) == (0, 0)
    assert torch.equal(got, want)
    assert (got[0] == 0).all() and (got[1] > 0).all()
    if precision == "highest":
        plain = fc.reference_factored_contract(pot.double(), w1.double(),
                                               flat.double())
        err = (got.double() - plain).abs().max() / plain.abs().max()
        assert err.item() <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("R1,R2g,rep,C", [(64, 64, 32, 2), (64, 64, 64, 1)])
def test_broadcast_read_at_the_cells_batch(cuda, R1, R2g, rep, C):
    """B = 262,144, the posterior cell's: the same bits as the expanded
    operand (2 and 4 GiB), read through a standing potential's kept
    operand as the serving path reads it."""
    B = 262_144
    pot, w1, view = _case(cuda, R1, R2g, rep, C, B, rep)
    rows = pot.permute(1, 0, 2).contiguous()  # [R2, R1, C], as the route
    fc.standing(rows, 1)
    lay = fc.StandingLayout(rows, [1], [0], [2], True)
    got = fc.factored_masked_contract(lay, w1, view)
    want = fc.factored_masked_contract(lay, w1, view.reshape(B, -1))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _clique_model(n=18):
    """One dense factor over n binary variables and n unaries: a single
    clique of 2^n states, the posterior cell's for n = 18."""
    rng = np.random.default_rng(0)
    names = [f"v{i}" for i in range(n)]
    values = [rng.random((2,) * n).astype(np.float32) + 0.1] + [
        rng.random(2) + 0.1 for _ in names]
    tree = jt.create_junction_tree([names[:]] + [[x] for x in names],
                                   {x: 2 for x in names})
    return tree, names, values


@pytest.mark.cuda
def test_big_clique_posterior_batch_reads_every_w2_by_broadcast(cuda):
    """A 2^18-state clique with 12 of 18 variables observed, B = 4096: all
    19 contractions of a call (18 marginals, R2 = 2,048; Z, 4,096) read
    ``w2`` by broadcast and copy nothing, and the posteriors and logZ match
    the float64 plain version, the impossible row included."""
    tree, names, values = _clique_model()
    evs = jt.random_evidence_batch(tree.plan, 4096, names[:12], seed=1)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    masks[names[0]][1] = 0.0  # an impossible row
    eng = tree.engine(device=cuda).set_potentials(values)
    eng.posterior_batch(masks)
    torch.cuda.synchronize()
    b0, m0 = _counters()
    post, logz = eng.posterior_batch(masks)
    torch.cuda.synchronize()
    b1, m1 = _counters()
    assert (b1 - b0, m1 - m0) == (19, 0)
    rpost, rlogz = tree.engine(device=cuda, dtype=torch.float64) \
        .set_potentials(values).posterior_batch(masks)
    assert torch.isneginf(logz[1]) and all((p[1] == 0).all() for p in post)
    fin = torch.isfinite(rlogz)
    assert (logz.double()[fin] - rlogz[fin]).abs().max().item() <= 2e-5
    for p, rp in zip(post, rpost):
        assert (p.double() - rp).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rep48", "rep16", "bf16", "narrow", "grad"])
def test_other_launches_keep_the_materialised_operand(cuda, case):
    """A ``rep`` that is not a multiple of 32, bfloat16 inputs, a narrow
    float32 product (the CUDA-core kernel) and a call that needs a gradient
    expand the view (counted in ``route.materialized_bytes``) and give what
    the expanded operand gives; the broadcast counter does not move."""
    rep = {"rep48": 48, "rep16": 16}.get(case, 32)
    R1 = 8 if case == "narrow" else 64
    pot, w1, view = _case(cuda, R1, 16, rep, 2, 1000, rep)
    if case == "bf16":  # rounded before the expansion, as the route does
        pot = pot.to(torch.bfloat16)
        view = view[:, :, 0].to(torch.bfloat16)[:, :, None].expand(view.shape)
    if case == "grad":
        w1.requires_grad_(True)
    flat = view.reshape(1000, -1).contiguous()
    b0, m0 = _counters()
    got = fc.factored_masked_contract(pot, w1, view)
    b1, m1 = _counters()
    want = fc.factored_masked_contract(pot, w1, flat)
    torch.cuda.synchronize()
    assert b1 == b0
    assert m1 - m0 == flat.numel() * flat.element_size()
    assert torch.equal(got, want)
    if case == "grad":
        assert got.grad_fn is not None
        g = torch.rand_like(got)
        (dw1,) = torch.autograd.grad(got, w1, g)
        want_dw1 = fc.factored_contract_grads(pot, w1.detach(), flat, g)[1]
        err = (dw1 - want_dw1).abs().max() / want_dw1.abs().max()
        assert err.item() <= 2e-6
