"""CUDA kernel tests; they need an NVIDIA GPU and skip elsewhere.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.ops import factored_contract as fc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R1,R2,C,B",
    [(64, 4096, 1, 4096), (64, 2048, 2, 4096), (1, 37, 1, 5),
     (3, 50, 17, 33), (5, 70, 300, 130), (2, 40, 3, 70000)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, R1, R2, C, B, dtype):
    """Serving-path shapes of the 2^18-state clique, ragged edges, C = 1,
    R1 = 1, C = 300 (r1 looped in the block), and a batch large enough that
    r2 is not split; f32 within 1e-5 and bf16 inputs within 2e-2 of
    max|out|."""
    g = torch.Generator(device=cuda).manual_seed(R1 + R2 + C + B)
    pot, w1, w2 = (
        torch.rand(shape, generator=g, device=cuda).to(dtype)
        for shape in ((R1, R2, C), (B, R1), (B, R2))
    )
    before = fc.factored_masked_contract.launches
    got = fc.factored_masked_contract(pot, w1, w2)
    torch.cuda.synchronize()
    assert fc.factored_masked_contract.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, C)
    want = fc.reference_factored_contract(pot, w1, w2)
    assert _rel_err(got, want) <= _tol(dtype)


def _rel_err(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R1,R2,C,B",
    [(4, 37, 3, 130),    # w2 rows unaligned (R2 odd), pot rows aligned
     (3, 64, 3, 40),     # pot rows unaligned (R1*C = 9), w2 rows aligned
     (2, 64, 50, 100),   # "c" tiling, C not a multiple of 4
     (2, 64, 48, 100),   # "c" tiling, aligned
     (3, 36, 4, 50),     # R2 a multiple of 4 but not of 8: f32 vector, bf16 scalar
     (64, 256, 2, 1),    # B = 1
     (16, 1, 2, 200),    # R2 = 1
     (1, 1, 1, 1)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_alignment_and_tiny_shapes(cuda, R1, R2, C, B, dtype):
    """Shapes whose rows are not 16-byte aligned take the kernel's scalar
    staging path, and one-row or one-step shapes its masked edges."""
    g = torch.Generator(device=cuda).manual_seed(R1 * 7 + R2 + C + B)
    pot, w1, w2 = (
        torch.rand(shape, generator=g, device=cuda).to(dtype)
        for shape in ((R1, R2, C), (B, R1), (B, R2))
    )
    got = fc.factored_masked_contract(pot, w1, w2)
    torch.cuda.synchronize()
    want = fc.reference_factored_contract(pot, w1, w2)
    assert _rel_err(got, want) <= _tol(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_offset_views(cuda, C, dtype):
    """pot and w2 as contiguous views one element into their storage: the
    shapes allow 16-byte copies, the addresses do not."""
    R1, R2, B = 8, 64, 130
    g = torch.Generator(device=cuda).manual_seed(C)
    pbuf = torch.rand(R1 * R2 * C + 1, generator=g, device=cuda).to(dtype)
    wbuf = torch.rand(B * R2 + 1, generator=g, device=cuda).to(dtype)
    w1 = torch.rand((B, R1), generator=g, device=cuda).to(dtype)
    if fc.tiles_by_n(C):  # already in the layout the kernel reads
        pot = pbuf[1:].view(R2, R1, C).permute(1, 0, 2)
    else:
        pot = pbuf[1:].view(R1, R2, C)
    w2 = wbuf[1:].view(B, R2)
    assert pot.data_ptr() % 16 != 0 and w2.data_ptr() % 16 != 0
    got = fc.factored_masked_contract(pot, w1, w2)
    torch.cuda.synchronize()
    want = fc.reference_factored_contract(pot, w1, w2)
    assert _rel_err(got, want) <= _tol(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("R1,R2,C", [(64, 2048, 2), (4, 96, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_keeps_subnormals_and_exact_zeros(cuda, R1, R2, C, dtype):
    """The serving floor 1e-38 is subnormal in f32 and bf16: a row whose
    weights are all 1e-38 must come out near R1*R2*1e-38 (not flushed to 0),
    and a row of exact zeros must come out exactly 0."""
    B = 130
    g = torch.Generator(device=cuda).manual_seed(1)
    pot = (torch.rand((R1, R2, C), generator=g, device=cuda) + 0.5).to(dtype)
    w1 = torch.ones((B, R1), device=cuda, dtype=dtype)
    w2 = torch.rand((B, R2), generator=g, device=cuda).to(dtype)
    w2[0] = 1e-38
    w2[1] = 0.0
    w2[2, ::2] = 1e-38
    w2[2, 1::2] = 0.0
    w1[3] = 0.0
    got = fc.factored_masked_contract(pot, w1, w2)
    torch.cuda.synchronize()
    want = fc.reference_factored_contract(pot, w1, w2)
    assert _rel_err(got, want) <= _tol(dtype)
    assert (want[0] > 0).all() and (want[2] > 0).all()
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=0)
    assert (got[1] == 0).all() and (got[3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R1,R2,C,B", [(64, 2048, 2, 4096), (64, 4096, 1, 4096), (5, 70, 300, 130)]
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_bitwise_repeatable(cuda, R1, R2, C, B, dtype):
    """The partial sums are added in a fixed order (no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    pot, w1, w2 = (
        torch.rand(shape, generator=g, device=cuda).to(dtype)
        for shape in ((R1, R2, C), (B, R1), (B, R2))
    )
    first = fc.factored_masked_contract(pot, w1, w2)
    second = fc.factored_masked_contract(pot, w1, w2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_kernel_rejects_float64(cuda):
    f64 = dict(dtype=torch.float64, device=cuda)
    pot, w1, w2 = torch.ones((2, 3, 1), **f64), torch.ones((4, 2), **f64), \
        torch.ones((4, 3), **f64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.factored_masked_contract(pot, w1, w2)


@pytest.mark.cuda
def test_posterior_batch_routes_through_kernel(cuda, monkeypatch):
    """A 2^12-state hub with tails, threshold lowered to 2^8: the serving
    program on the card launches the kernel and agrees with the float64
    plain run on the CPU."""
    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    rng = np.random.default_rng(4)
    hub = [f"h{i}" for i in range(12)]
    factors = [hub] + [[h] for h in hub] + [[hub[i], f"t{i}"] for i in range(4)]
    sizes = {**{h: 2 for h in hub}, **{f"t{i}": 2 for i in range(4)}}
    values = [rng.random(tuple(sizes[v] for v in f)) + 0.1 for f in factors]
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, 300, ["t0", "t1", "h5", "h6"], seed=2)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    masks["t0"][1] = 0.0
    before = fc.factored_masked_contract.launches
    post, logz = tree.engine(device=cuda).set_potentials(values).posterior_batch(masks)
    torch.cuda.synchronize()
    assert fc.factored_masked_contract.launches > before
    rpost, rlogz = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values) \
        .posterior_batch(masks)
    assert torch.isneginf(logz[1]) and all((p[1] == 0).all() for p in post)
    fin = torch.isfinite(rlogz)
    np.testing.assert_allclose(logz.cpu()[fin].double(), rlogz[fin], atol=1e-4)
    for p, rp in zip(post, rpost):
        np.testing.assert_allclose(p.cpu().double(), rp, rtol=1e-4, atol=1e-6)
