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
    R1 = 1, and a batch large enough that r2 is not split; f32 within 1e-5
    and bf16 inputs within 2e-2 of max|out|."""
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
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= (1e-5 if dtype == torch.float32 else 2e-2)


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
    rpost, rlogz = tree.engine(dtype=torch.float64).set_potentials(values) \
        .posterior_batch(masks)
    assert torch.isneginf(logz[1]) and all((p[1] == 0).all() for p in post)
    fin = torch.isfinite(rlogz)
    np.testing.assert_allclose(logz.cpu()[fin].double(), rlogz[fin], atol=1e-4)
    for p, rp in zip(post, rpost):
        np.testing.assert_allclose(p.cpu().double(), rp, rtol=1e-4, atol=1e-6)
