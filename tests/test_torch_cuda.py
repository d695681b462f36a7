"""CUDA kernel tests; they need an NVIDIA GPU and skip elsewhere.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.config import DEFAULT
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS


def _count(name):
    """The port's counter ``name`` now (``TIMERS.counters()``)."""
    return TIMERS.counters()[name]


def _k1(name):
    """The kernel wrapper's counter ``factored_masked_contract.<name>``."""
    return _count("factored_masked_contract." + name)


@pytest.fixture(autouse=True)
def _autotune_cache(tmp_path, monkeypatch):
    """Measured decisions (``ops.autotune``) go to a temporary file; the
    package's defaults stay as they are."""
    monkeypatch.setattr(DEFAULT, "autotune_cache_dir", str(tmp_path))


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
     (3, 50, 17, 33), (5, 70, 300, 130), (2, 40, 3, 70000),
     # one model shard of each serving shape (shard_model over 4)
     (16, 4096, 1, 4096), (16, 2048, 2, 4096),
     # entropy_batch (C = 1, above) and joint_marginal_batch over 2, 3, 5
     # and 6 of the 2^18-state clique's unobserved variables: both column
     # tilings around C = 32, then R1 = 1 and unaligned rows at those C
     (64, 1024, 4, 4096), (64, 512, 8, 4096), (64, 128, 32, 4096),
     (64, 64, 64, 4096), (1, 512, 8, 4096), (1, 37, 4, 130),
     (3, 37, 8, 130), (1, 50, 64, 100), (3, 37, 33, 130)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, R1, R2, C, B, dtype):
    """Serving-path shapes of the 2^18-state clique (posteriors, entropy,
    joints) and their model shards, ragged edges, C = 1, R1 = 1, C = 300 (r1
    looped in the block), and a batch large enough that r2 is not split;
    f32 within 1e-5 and bf16 inputs within 2e-2 of max|out|."""
    g = torch.Generator(device=cuda).manual_seed(R1 + R2 + C + B)
    pot, w1, w2 = (
        torch.rand(shape, generator=g, device=cuda).to(dtype)
        for shape in ((R1, R2, C), (B, R1), (B, R2))
    )
    before = _k1("launches")
    got = fc.factored_masked_contract(pot, w1, w2)
    torch.cuda.synchronize()
    assert _k1("launches") == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, C)
    want = fc.reference_factored_contract(pot, w1, w2)
    assert _rel_err(got, want) <= _tol(dtype)


def _rel_err(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("N", range(1, 65))
def test_f32_kernel_at_every_column_count(cuda, N):
    """float32 at every N = R1*C from 1 to 64 at B = 4096: the narrow column
    tiles (16 and 32 columns) and the 64-column one, each with its ragged
    edge, within 1e-5 of max|out|."""
    C = 2 if N % 2 == 0 else 1
    R1, R2, B = N // C, 300, 4096
    g = torch.Generator(device=cuda).manual_seed(N)
    pot, w1, w2 = (torch.rand(shape, generator=g, device=cuda)
                   for shape in ((R1, R2, C), (B, R1), (B, R2)))
    got = fc.factored_masked_contract(pot, w1, w2)
    torch.cuda.synchronize()
    want = fc.reference_factored_contract(pot, w1, w2)
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R1,R2,C",
    [(64, 2048, 2), (64, 4096, 1),        # posterior_batch, entropy terms
     (64, 1024, 4), (64, 512, 8),         # joints over 2 and 3 variables
     (512, 256, 2), (512, 512, 1),        # E-step forward
     (2, 2048, 64), (2, 64, 2048),        # dw1, dw2 at the serving shape
     (1, 4096, 64), (1, 64, 4096),        # dw1, dw2 at C = 1
     (2, 256, 512), (2, 512, 256)],       # the E-step's backward
)
def test_f32_kernel_on_path_shapes_within_2e6(cuda, R1, R2, C):
    """float32 at "highest" (six bf16 passes on the tensor cores) stays
    within 2e-6 of max|out| of the plain version at every shape a serving
    or gradient path hands it, with the potential in the layout the route
    hands over, and two runs are bitwise equal."""
    B = 4096
    g = torch.Generator(device=cuda).manual_seed(R1 * 3 + R2 + C)
    if fc.tiles_by_n(C):
        pot = torch.rand((R2, R1, C), generator=g, device=cuda).permute(1, 0, 2)
    else:
        pot = torch.rand((R1, R2, C), generator=g, device=cuda)
    w1 = torch.rand((B, R1), generator=g, device=cuda)
    w2 = torch.rand((B, R2), generator=g, device=cuda)
    k1 = fc.factored_masked_contract
    before = _k1("splits")
    got = k1(pot, w1, w2)
    again = k1(pot, w1, w2)
    torch.cuda.synchronize()
    assert _k1("splits") == before + 2
    assert _rel_err(got, fc.reference_factored_contract(pot, w1, w2)) <= 2e-6
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("R1,R2,C,B", [(64, 2048, 2, 4096), (5, 70, 300, 130),
                                       (16, 2048, 2, 4096), (3, 37, 33, 130)])
def test_precision_argument_on_the_card(cuda, R1, R2, C, B):
    """precision="default" is one bf16 pass: within 2e-2 of max|out| (and
    exact on the narrow CUDA-core route); bf16 inputs take one pass
    whatever is asked; any other precision raises."""
    g = torch.Generator(device=cuda).manual_seed(R2 + C)
    pot, w1, w2 = (torch.rand(s, generator=g, device=cuda)
                   for s in ((R1, R2, C), (B, R1), (B, R2)))
    want = fc.reference_factored_contract(pot, w1, w2)
    got = fc.factored_masked_contract(pot, w1, w2, precision="default")
    torch.cuda.synchronize()
    narrow = fc.tiles_by_n(C) and R1 * C <= fc.FMA_MAX_N
    assert _rel_err(got, want) <= (1e-5 if narrow else 2e-2)
    pb, w2b = pot.bfloat16(), w2.bfloat16()
    assert torch.equal(fc.factored_masked_contract(pb, w1, w2b, "default"),
                       fc.factored_masked_contract(pb, w1, w2b, "highest"))
    with pytest.raises(ValueError, match="precision"):
        fc.factored_masked_contract(pot, w1, w2, precision="high")


def kernel_split(pot, B, precision="highest"):
    """The kernel's split of a float32 pot as the wrapper launches it:
    (planes [planes, rows, ld] bf16, box exponents int32)."""
    from junctiontree_tpu_torch.ops.cuda_build import load_library

    R1, R2, C = (int(d) for d in pot.shape)
    cfg = fc.launch_config(B, R1, R2, C, 132, False, precision=precision)
    buf, ld, _ = fc._split_pot(load_library(), pot, cfg,
                               torch.cuda.current_stream().cuda_stream)
    rows = R2 if cfg["by_n"] else R1 * R2
    n = cfg["planes"] * rows * ld
    torch.cuda.synchronize()
    return (buf[:n].view(cfg["planes"], rows, ld),
            buf[n:].view(torch.int32), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R1,R2,C,layout",
    [(64, 2048, 2, "rows"), (64, 4096, 1, "rows"), (2, 64, 2048, "perm"),
     (2, 2048, 64, "perm"), (5, 70, 300, "plain"), (3, 37, 33, "plain"),
     (40, 50, 2, "plain")],
)
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_split_matches_plain_version(cuda, R1, R2, C, layout, precision):
    """The pot split kernel writes the same bits as its plain version
    (``reference_split_pot``), reading the potential through its strides:
    the route's [R2, R1, C] rows, a backward pass's permuted view, or a
    plain [R1, R2, C] tensor; tiny boxes keep their bits."""
    g = torch.Generator(device=cuda).manual_seed(R1 + R2 + C)
    if layout == "rows":
        pot = torch.rand((R2, R1, C), generator=g, device=cuda).permute(1, 0, 2)
    elif layout == "perm":  # as _contract_grads hands dw2 its potential
        pot = torch.rand((R2, C, R1), generator=g, device=cuda).permute(2, 0, 1)
    else:
        pot = torch.rand((R1, R2, C), generator=g, device=cuda)
    pot.mul_(torch.where(torch.rand(pot.shape, generator=g, device=cuda)
                         < 0.1, 1e-36, 1.0))  # in place: the strides stay
    planes, exps, cfg = kernel_split(pot, 4096, precision)
    want, want_exps = fc.reference_split_pot(pot, cfg["by_n"], cfg["bk"],
                                             cfg["planes"])
    assert torch.equal(exps, want_exps)
    assert torch.equal(planes, want)


@pytest.mark.cuda
@pytest.mark.parametrize("R1,R2,C", [(64, 2048, 2), (64, 4096, 1)])
def test_bf16_kernel_serving_shapes_within_2e6(cuda, R1, R2, C):
    """At the two serving shapes the bf16 kernel (f32 sums of exact
    products, no tensor-core sum longer than 64 terms) stays within 2e-6
    of max|out| of the plain version on the same bf16 inputs."""
    B = 4096
    g = torch.Generator(device=cuda).manual_seed(R2 + C)
    pot = torch.rand((R2, R1, C), generator=g, device=cuda).to(
        torch.bfloat16).permute(1, 0, 2)
    w1 = torch.rand((B, R1), generator=g, device=cuda)
    w2 = torch.rand((B, R2), generator=g, device=cuda).to(torch.bfloat16)
    got = fc.factored_masked_contract(pot, w1, w2)
    torch.cuda.synchronize()
    want = fc.reference_factored_contract(pot, w1, w2)
    assert _rel_err(got, want) <= 2e-6


@pytest.mark.cuda
def test_bf16_padding_count(cuda):
    """bf16 operands reach the Tensor Memory Accelerator as they are on the
    serving shapes (no copy counted), and offset views and odd rows are
    copied into an aligned buffer (counted); float32 serving operands are
    not copied either (pot goes through the split, which reads any
    strides), and a float32 w2 at an offset is copied and counted."""
    k1 = fc.factored_masked_contract
    for R1, R2, C in ((64, 2048, 2), (64, 4096, 1), (16, 2048, 2)):
        pot = torch.rand((R2, R1, C), device=cuda).to(
            torch.bfloat16).permute(1, 0, 2)
        w1 = torch.rand((4096, R1), device=cuda)
        w2 = torch.rand((4096, R2), device=cuda).to(torch.bfloat16)
        before = _k1("padded")
        k1(pot, w1, w2)
        k1(pot.float(), w1, w2.float())
        assert _k1("padded") == before
    wbuf = torch.rand(130 * 40 + 1, device=cuda).to(torch.bfloat16)
    w2 = wbuf[1:].view(130, 40)               # address not 16-byte aligned
    pot = torch.rand((8, 40, 2), device=cuda).to(torch.bfloat16)  # N = 16
    w1 = torch.rand((130, 8), device=cuda)
    before = _k1("padded")
    k1(pot, w1, w2)
    assert _k1("padded") == before + 1
    k1(pot[:, :, :1].contiguous(), w1, w2)     # N = 8, w2 still offset
    assert _k1("padded") == before + 2
    k1(torch.rand((3, 40, 3), device=cuda).to(torch.bfloat16),
       torch.rand((130, 3), device=cuda), w2.clone())  # N = 9, w2 aligned
    assert _k1("padded") == before + 3
    fbuf = torch.rand(130 * 40 + 1, device=cuda)
    pot = torch.rand((40, 40, 2), device=cuda)  # N = 80: the tensor cores
    w1 = torch.rand((130, 40), device=cuda)
    k1(pot, w1, fbuf[:-1].view(130, 40))       # aligned: no copy
    assert _k1("padded") == before + 3
    k1(pot, w1, fbuf[1:].view(130, 40))        # one float in: copied
    assert _k1("padded") == before + 4
    torch.cuda.synchronize()


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
@pytest.mark.parametrize(
    "R1,R2,C", [(64, 2048, 2), (4, 96, 40), (16, 4096, 1), (5, 96, 3)])
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
    "R1,R2,C,B", [(64, 2048, 2, 4096), (64, 4096, 1, 4096), (5, 70, 300, 130),
                  (16, 2048, 2, 4096), (16, 4096, 1, 4096), (5, 96, 3, 300),
                  (64, 128, 32, 4096)]
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_bitwise_repeatable(cuda, R1, R2, C, B, dtype):
    """The partial sums are added in a fixed order (no atomics): the narrow
    f32 tiles and the bf16 cluster sums in rank order too."""
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
def test_bf16_kernels_run_on_wgmma_and_tma(cuda):
    """``cuobjdump -sass`` of the built library: every tensor-core kernel,
    bf16 and float32 at both precisions (three epilogues each, and the
    pairwise fold of six passes), holds HGMMA
    and UTMALDG instructions; the narrow float32 kernel (N <= 32, the
    CUDA-core route the model shards keep), the pot split, the tree-MAP
    program's fused collect and the chain program's row pass hold no
    tensor-core instruction, and there is no other kernel
    (the partials of a split r2 sum are added inside the contraction
    kernels)."""
    from junctiontree_tpu_torch.ops import cuda_build

    cuda_build.load_library()
    counts = cuda_build.sass_op_counts()
    tc_kinds = {src + epi for src in ("bf16", "f32", "f32_default")
                for epi in ("_by_c", "_fold", "_smem")} | {"f32_fold_pairs"}
    assert tc_kinds | {"f32_narrow", "split", "map_collect",
                       "chain_step"} == set(counts)
    for kind, ops in counts.items():
        tensor = sum(ops[op] for op in cuda_build.TENSOR_CORE_OPS)
        if kind in tc_kinds:
            assert ops["HGMMA"] > 0 and ops["UTMALDG"] > 0, (kind, ops)
        else:
            assert tensor == 0 and ops["UTMALDG"] == 0, (kind, ops)


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
    before = _k1("launches")
    post, logz = tree.engine(device=cuda).set_potentials(values).posterior_batch(masks)
    torch.cuda.synchronize()
    assert _k1("launches") > before
    rpost, rlogz = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values) \
        .posterior_batch(masks)
    assert torch.isneginf(logz[1]) and all((p[1] == 0).all() for p in post)
    fin = torch.isfinite(rlogz)
    np.testing.assert_allclose(logz.cpu()[fin].double(), rlogz[fin], atol=1e-4)
    for p, rp in zip(post, rpost):
        np.testing.assert_allclose(p.cpu().double(), rp, rtol=1e-4, atol=1e-6)


def _hub_model():
    rng = np.random.default_rng(4)
    hub = [f"h{i}" for i in range(12)]
    factors = [hub] + [[h] for h in hub] + [[hub[i], f"t{i}"] for i in range(4)]
    sizes = {**{h: 2 for h in hub}, **{f"t{i}": 2 for i in range(4)}}
    values = [rng.random(tuple(sizes[v] for v in f)) + 0.1 for f in factors]
    return factors, sizes, values


@pytest.mark.cuda
def test_bf16_serving_launches_kernel_with_bf16_inputs(cuda, monkeypatch):
    """bfloat16 storage on the card: every routed contraction launches the
    kernel with bf16 inputs, outputs are float32, and the result is within
    the bf16 limits (posteriors 0.02, logZ 0.05) of the float32 engine; an
    impossible row keeps the contract."""
    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    factors, sizes, values = _hub_model()
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, 300, ["t0", "t1", "h5", "h6"], seed=2)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    masks["t0"][1] = 0.0
    e32 = tree.engine(device=cuda, dtype=torch.float32).set_potentials(values)
    before = _k1("launches")
    want, want_logz = e32.posterior_batch(masks)
    n32 = _k1("launches") - before
    e16 = tree.engine(device=cuda, dtype=torch.bfloat16).set_potentials(values)
    before = _k1("launches")
    before16 = _k1("launches_bf16")
    post, logz = e16.posterior_batch(masks)
    torch.cuda.synchronize()
    n16 = _k1("launches") - before
    assert n32 > 0 and n16 == n32
    assert _k1("launches_bf16") - before16 == n16
    assert logz.dtype == torch.float32 and all(p.dtype == torch.float32 for p in post)
    assert torch.isneginf(logz[1]) and all((p[1] == 0).all() for p in post)
    fin = torch.isfinite(want_logz)
    assert (logz - want_logz)[fin].abs().max().item() <= 0.05
    for p, w in zip(post, want):
        assert not torch.isnan(p).any()
        assert (p - w).abs().max().item() <= 0.02


def _same_on_cpu(build, run, n_vars, rtol=1e-4, atol=1e-6, logz_atol=1e-3):
    """``run(engine)`` on the card against the same engine on the CPU."""
    post, logz = run(build(torch.device("cuda")))
    torch.cuda.synchronize()
    rpost, rlogz = run(build("cpu"))
    assert torch.equal(torch.isneginf(logz.cpu()), torch.isneginf(rlogz))
    fin = torch.isfinite(rlogz)
    np.testing.assert_allclose(logz.cpu()[fin], rlogz[fin], rtol=0, atol=logz_atol)
    for v in range(n_vars):
        assert not torch.isnan(post[v]).any()
        np.testing.assert_allclose(post[v].cpu(), rpost[v], rtol=rtol, atol=atol)
    return post, rpost


@pytest.mark.cuda
def test_chain_program_on_cuda_matches_cpu(cuda):
    from junctiontree_tpu_torch.models import chain_bn_model
    from junctiontree_tpu_torch.scan_executor import StackedPosteriors

    factors, sizes, values = chain_bn_model(300, card=3, seed=1)
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, 33, ["x0", "x150", "x299"], seed=2)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    masks["x150"][4] = 0.0
    post, _ = _same_on_cpu(
        lambda d: tree.engine(device=d).set_potentials(values),
        lambda e: e.posterior_batch(masks), 300)
    assert isinstance(post, StackedPosteriors) and post.stacked.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["star", "grid"])
def test_fused_program_on_cuda_matches_cpu(cuda, model):
    from junctiontree_tpu_torch.fused import FusedPosteriors
    from junctiontree_tpu_torch.models import grid_mrf_model, star_bn_model

    factors, sizes, values = (
        star_bn_model(60) if model == "star" else grid_mrf_model(5, 5, seed=2))
    tree = jt.create_junction_tree(factors, sizes)
    labels = list(sizes)[1::7]
    evs = jt.random_evidence_batch(tree.plan, 40, labels, seed=3)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    masks[labels[0]][2] = 0.0
    post, _ = _same_on_cpu(
        lambda d: tree.engine(device=d).set_potentials(values),
        lambda e: e.posterior_batch(masks, mode="fused"), len(sizes))
    assert isinstance(post, FusedPosteriors)


@pytest.mark.cuda
@pytest.mark.parametrize("semiring", ["log_sum_exp", "max_product"])
@pytest.mark.parametrize("big_scope", [False, True])
def test_log_engines_on_cuda_match_cpu(cuda, semiring, big_scope, monkeypatch):
    from junctiontree_tpu_torch.models import grid_mrf_model
    from junctiontree_tpu_torch.ops import semirings

    if big_scope:
        monkeypatch.setattr(semirings, "LOG_EINSUM_MIN_STATES", 1)
    sr = jt.SEMIRINGS[semiring]
    factors, sizes, values = grid_mrf_model(4, 4, seed=6)
    tree = jt.create_junction_tree(factors, sizes)
    evs = jt.random_evidence_batch(tree.plan, 9, list(sizes)[:4], seed=7)
    masks = jt.batch_masks_sparse(tree.plan, evs, sr)
    masks[list(sizes)[0]][1] = -np.inf
    _same_on_cpu(
        lambda d: tree.engine(semiring, device=d).set_potentials(values),
        lambda e: e.posterior_batch(masks), len(sizes))


@pytest.mark.cuda
def test_chunked_and_division_on_cuda_match_cpu(cuda, monkeypatch):
    from junctiontree_tpu_torch.models import alarm_like

    factors, sizes, values = alarm_like(seed=1)
    tree = jt.create_junction_tree(factors, sizes)
    labels = list(sizes)[::3]
    evs = jt.random_evidence_batch(tree.plan, 50, labels, seed=5)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    masks[labels[0]][40] = 0.0
    post, _ = _same_on_cpu(
        lambda d: tree.engine(device=d).set_potentials(values),
        lambda e: e.posterior_batch(masks, chunk=16), len(sizes))
    assert all(tuple(p.shape) == (50, s) for p, s in zip(post, tree.plan.sizes))
    monkeypatch.setattr(DEFAULT, "distribute_division", True)
    _same_on_cpu(
        lambda d: jt.Engine(tree.plan, device=d).set_potentials(values),
        lambda e: e.posterior_batch(masks, mode="general"), len(sizes))
    qm, qz = tree.engine(device=cuda).set_potentials(values).query_batch(masks)
    rm, rz = tree.engine(device="cpu").set_potentials(values).query_batch(masks)
    np.testing.assert_allclose(qz.cpu(), rz, rtol=1e-4, atol=1e-30)
    for a, b in zip(qm, rm):
        np.testing.assert_allclose(a.cpu(), b, rtol=1e-4, atol=1e-30)


def _routed_queries(device, dtype, masks, upd):
    """Entropy, two joints and an incremental delta on the hub model."""
    factors, sizes, values = _hub_model()
    eng = jt.create_junction_tree(factors, sizes).engine(
        device=device, dtype=dtype).set_potentials(values)
    out = [*eng.entropy_batch(masks),
           *eng.joint_marginal_batch(["h0", "h9"], masks),
           *eng.joint_marginal_batch(["h9", "h2", "t3"], masks)]
    posts, logz = eng.incremental(masks).query(upd, ["h1", "t2"])
    return out + list(posts) + [logz]


@pytest.mark.cuda
def test_entropy_joint_incremental_route_through_kernel(cuda, monkeypatch):
    """Threshold lowered to 2^8: entropy_batch, joint_marginal_batch and an
    incremental session on the card launch the kernel (none of them falls
    to the plain version or an einsum for a routed contraction) and agree
    with the float64 run on the CPU within rtol 1e-4 / atol 1e-6; the
    impossible row gives H = 0, Z = 0, a zero table and logZ = -inf."""
    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    factors, sizes, _ = _hub_model()
    plan = jt.compile_plan(factors, sizes)
    masks = jt.batch_masks_sparse(plan, jt.random_evidence_batch(
        plan, 300, ["t0", "t1", "h5", "h6", "h7"], seed=2))
    masks["h5"][1] = 0.0
    upd = {"t1": np.tile(np.array([[0.0, 1.0]], dtype=np.float32), (300, 1))}
    launched, plain_calls = [], []
    kernel, plain = fc.factored_masked_contract, fc.reference_factored_contract
    monkeypatch.setattr(
        fc, "reference_factored_contract",
        lambda *a: plain_calls.append(1) or plain(*a))
    before = _k1("launches")
    calls_before = _count("big_clique_sep_message.calls")
    got = _routed_queries(cuda, torch.float32, masks, upd)
    torch.cuda.synchronize()
    launched = _k1("launches") - before
    assert launched == _count("big_clique_sep_message.calls") - calls_before > 10
    assert not plain_calls
    want = _routed_queries("cpu", torch.float64, masks, upd)
    for g, w in zip(got, want):
        g = g.cpu().double()
        assert not torch.isnan(g).any()
        assert torch.equal(torch.isneginf(g), torch.isneginf(w))
        fin = torch.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-4, atol=1e-6)
    ent, z, table = got[0], got[1], got[2]
    assert ent[1] == 0 and z[1] == 0 and (table[1] == 0).all()
    assert torch.isneginf(got[-1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("big_scope", [False, True])
def test_log_entropy_batch_on_cuda_matches_cpu(cuda, big_scope, monkeypatch):
    """``entropy_batch`` on a log-sum-exp engine (the per-element form under
    ``torch.vmap``; with ``big_scope`` every several-operand contraction
    takes the log-matmul-exp branch) on the card against the float64
    sum-product run on the CPU: rtol 1e-4 / atol 1e-5, and an impossible
    row of H = 0, Z = 0."""
    from junctiontree_tpu_torch.models import alarm_like
    from junctiontree_tpu_torch.ops import semirings

    if big_scope:
        monkeypatch.setattr(semirings, "LOG_EINSUM_MIN_STATES", 1)
    factors, sizes, values = alarm_like(seed=4)
    tree = jt.create_junction_tree(factors, sizes)
    labels = list(sizes)[::4]
    evs = jt.random_evidence_batch(tree.plan, 33, labels, seed=2)
    masks = jt.batch_masks_sparse(tree.plan, evs)
    lmasks = jt.batch_masks_sparse(tree.plan, evs, jt.LOG_SUM_EXP)
    masks[labels[0]][1] = 0.0
    lmasks[labels[0]][1] = -np.inf
    dev = tree.engine("log_sum_exp", device=cuda).set_potentials(values)
    ent, z = dev.entropy_batch(lmasks)
    assert ent.is_cuda and ent.dtype == torch.float32
    cpu = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    want, want_z = cpu.entropy_batch(masks)
    assert float(ent[1]) == 0.0 and float(z[1]) == 0.0
    np.testing.assert_allclose(ent.cpu().double(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(z.cpu().double(), want_z, rtol=1e-4, atol=1e-30)
    one, _ = dev.entropy(evs[0])
    assert one == pytest.approx(float(want[0]), rel=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["grid", "chain", "alarm"])
def test_map_and_kbest_on_cuda_match_cpu_scores(cuda, model):
    """MAP and k-best on the card against the CPU: equal scores (float32,
    rtol 1e-5), int32 assignments that attain them, distinct k-best lists.
    Assignments are not compared index for index: torch's CUDA ``topk``
    and ``max`` may order equal scores differently from the CPU's."""
    from junctiontree_tpu_torch.models import (
        alarm_like, chain_bn_model, grid_mrf_model)

    factors, sizes, values = {
        "grid": lambda: grid_mrf_model(4, 4, seed=3),
        "chain": lambda: chain_bn_model(200, card=3, seed=3),
        "alarm": lambda: alarm_like(seed=3),
    }[model]()
    tree = jt.create_junction_tree(factors, sizes)
    labels = list(sizes)[::5][:4]
    B = 17
    rng = np.random.default_rng(0)
    masks = {}
    for v in labels:
        m = np.full((B, sizes[v]), -np.inf, dtype=np.float32)
        m[np.arange(B), rng.integers(0, sizes[v], B)] = 0.0
        masks[v] = m
    masks[labels[0]][3] = -np.inf  # an infeasible row
    dev = tree.engine("max_product", device=cuda).set_potentials(values)
    cpu = tree.engine("max_product", device="cpu").set_potentials(values)
    a, s = dev.map_assignment_batch(masks)
    a2, s2 = dev.map_assignment_batch(masks, chunk=5)
    ra, rs = cpu.map_assignment_batch(masks)
    assert a.is_cuda and a.dtype == torch.int32
    assert torch.equal(s, s2) and torch.equal(a, a2)
    assert float(s[3]) < -1e29 and float(rs[3]) < -1e29
    ok = [b for b in range(B) if b != 3]
    np.testing.assert_allclose(s.cpu()[ok], rs[ok], rtol=1e-5)
    for b in ok[:5]:
        row = {tree.plan.table.label_of(v): int(a[b, v])
               for v in range(tree.plan.num_vars)}
        assert dev.score_assignment(row) == pytest.approx(float(s[b]), rel=1e-4)
    ka, ks = dev.top_k_assignments_batch(masks, k=4)
    _, rks = cpu.top_k_assignments_batch(masks, k=4)
    np.testing.assert_allclose(ks.cpu()[ok], rks[ok], rtol=1e-5)
    np.testing.assert_allclose(ks[:, 0].cpu()[ok], s.cpu()[ok], rtol=1e-5)
    assert (ks[:, :-1] >= ks[:, 1:]).all()
    for b in ok[:5]:
        assert len({tuple(r) for r in ka[b].tolist()}) == 4
    top = dev.top_k_assignments({labels[1]: 0}, k=3)
    rtop = cpu.top_k_assignments({labels[1]: 0}, k=3)
    np.testing.assert_allclose([x for _, x in top], [x for _, x in rtop], rtol=1e-5)


@pytest.mark.cuda
def test_load_on_cuda_and_multiply_factor(cuda, tmp_path):
    """save on the CPU, load(device="cuda"): the same posteriors as an
    engine built on the card (bitwise), and a live edit is served."""
    from junctiontree_tpu_torch.models import alarm_like

    factors, sizes, values = alarm_like(seed=2)
    tree = jt.create_junction_tree(factors, sizes)
    path = str(tmp_path / "alarm.npz")
    tree.engine(device="cpu").set_potentials(values).save(path)
    eng = jt.Engine.load(path, device="cuda")
    assert eng.device.type == "cuda" and eng._pots[0].is_cuda
    built = tree.engine(device=cuda).set_potentials(values)
    labels = list(sizes)[::4]
    masks = jt.batch_masks_sparse(
        tree.plan, jt.random_evidence_batch(tree.plan, 20, labels, seed=1))
    post, logz = eng.posterior_batch(masks)
    want, want_logz = built.posterior_batch(masks)
    assert torch.equal(logz, want_logz)
    assert all(torch.equal(a, b) for a, b in zip(post, want))
    v0 = tree.plan.table.label_of(tree.plan.tri.maxcliques[0][0])
    val = np.linspace(0.5, 2.0, sizes[v0])
    eng.multiply_factor([v0], val)
    cpu = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    cpu.multiply_factor([v0], val)
    _, z1 = eng.posterior_batch(masks)
    _, z2 = cpu.posterior_batch(masks)
    np.testing.assert_allclose(z1.cpu().double(), z2, atol=1e-4)
    assert eng.describe()["device"].startswith("cuda")


# -- the kernel's gradient, learning and the solvers beside the engine ------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "R1,R2,C,B",
    [(64, 2048, 2, 4096), (64, 4096, 1, 4096),   # the serving shapes
     (8, 40, 1, 50), (4, 37, 33, 130), (3, 50, 64, 33),   # C = 1, 33, 64
     (1, 512, 8, 100),    # R1 = 1
     (3, 37, 3, 130),     # unaligned rows
     (16, 64, 2, 1)],     # B = 1
)
def test_function_gradients_match_autograd_of_plain(cuda, R1, R2, C, B):
    """The three gradients of the autograd Function (dw1, dw2: the kernel on
    a permuted potential; dpot: one matrix product) within 1e-5 of max|grad|
    of ``torch.autograd.grad`` of the plain version, two kernel launches
    counted as backward launches, two runs bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(R1 * 7 + R2 + C + B)
    mk = lambda *s: torch.rand(s, generator=g, device=cuda)
    pot, w1, w2, up = mk(R1, R2, C), mk(B, R1), mk(B, R2), mk(B, C)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (pot, w1, w2)]
        out = fn(*leaves)
        assert out.grad_fn is not None
        return torch.autograd.grad(out, leaves, up)

    k1 = fc.factored_masked_contract
    before, back = _k1("launches"), _k1("launches_backward")
    got = grads(k1)
    torch.cuda.synchronize()
    assert _k1("launches") == before + 3 and _k1("launches_backward") == back + 2
    want = grads(fc.reference_factored_contract)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel_err(a, b) <= 1e-5
    for a, b in zip(got, grads(k1)):
        assert torch.equal(a, b)
    for a, b in zip(fc.factored_contract_grads(pot, w1, w2, up), want):
        assert _rel_err(a, b) <= 1e-5


@pytest.mark.cuda
def test_function_skips_gradients_nobody_asks_for(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    pot, w1, w2 = (torch.rand(s, generator=g, device=cuda)
                   for s in ((8, 64, 2), (40, 8), (40, 64)))
    k1 = fc.factored_masked_contract
    pot.requires_grad_(True)
    before, back = _k1("launches"), _k1("launches_backward")
    out = k1(pot, w1, w2)
    (dpot,) = torch.autograd.grad(out.sum(), [pot])
    assert _k1("launches") == before + 1 and _k1("launches_backward") == back
    ref = pot.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        fc.reference_factored_contract(ref, w1, w2).sum(), [ref])
    assert _rel_err(dpot, want) <= 1e-5
    with torch.no_grad():
        assert k1(pot, w1, w2).grad_fn is None


@pytest.mark.cuda
def test_bf16_input_requiring_grad_raises_on_cuda(cuda):
    pot = torch.rand((4, 32, 2), device=cuda)
    w1, w2 = torch.rand((8, 4), device=cuda), torch.rand((8, 32), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fc.factored_masked_contract(
            pot.to(torch.bfloat16).requires_grad_(True), w1, w2)
    with pytest.raises(TypeError, match="bfloat16"):
        fc.factored_masked_contract(
            pot, w1, w2.to(torch.bfloat16).requires_grad_(True))


@pytest.mark.cuda
def test_gradient_flows_through_big_clique_sep_message(cuda):
    """A clique of 2^10 states with masks on rest and separator variables,
    a rest-scoped message and ``w2`` expanded over the unobserved rest
    variables: the gradient w.r.t. the potential, the masks and the message
    against float64 autograd of the same call (which takes the plain
    version), limit 1e-4 of max|grad|."""
    rng = np.random.default_rng(0)
    cvars = list(range(10))
    B = 64
    pot = rng.random((2,) * 10) + 0.1
    masks = {1: rng.random((B, 2)) + 0.1, 8: rng.random((B, 2)) + 0.1}
    msg = rng.random((B, 2, 2)) + 0.1
    sep = [8, 9]

    def run(dtype):
        leaves = [torch.tensor(x, dtype=dtype, device=cuda, requires_grad=True)
                  for x in (pot, masks[1], masks[8], msg)]
        out = fc.big_clique_sep_message(
            leaves[0], cvars, {1: leaves[1], 8: leaves[2]}, sep,
            msgs=[((0, 2), leaves[3])])
        return out, torch.autograd.grad((out ** 2).sum(), leaves)

    before, back = _k1("launches"), _k1("launches_backward")
    out, got = run(torch.float32)
    assert _k1("launches") == before + 3 and _k1("launches_backward") == back + 2
    ref, want = run(torch.float64)
    assert _k1("launches") == before + 3
    assert _rel_err(out.double(), ref) <= 1e-5
    for a, b in zip(got, want):
        assert _rel_err(a.double(), b) <= 1e-4


@pytest.mark.cuda
def test_expected_counts_route_through_kernel(cuda, monkeypatch):
    """``learn.expected_counts`` on a dense clique with tails, the route
    lowered to 2^8 states: forward and backward launches, counts within
    1e-4 of the float64 run (the plain version)."""
    from junctiontree_tpu_torch import learn

    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    rng = np.random.default_rng(0)
    n = 9
    names = [f"v{i}" for i in range(n)]
    tails = [f"t{i}" for i in range(n)]
    factors = [names[:]] + [[x] for x in names] + [[x, t] for x, t in zip(names, tails)]
    sizes = {x: 2 for x in names + tails}
    values = [rng.random((2,) * n) + 0.1] + [rng.random(2) + 0.1 for _ in names] \
        + [rng.random((2, 2)) + 0.1 for _ in tails]
    plan = jt.compile_plan(factors, sizes)
    data = rng.integers(0, 2, size=(200, plan.num_vars))
    data[rng.random(data.shape) < 0.3] = -1
    masks = learn.masks_from_data(plan, data)
    before, back = _k1("launches"), _k1("launches_backward")
    counts = learn.expected_counts(plan, values, masks, device=cuda)
    assert _k1("launches") - before > _k1("launches_backward") - back > 0
    mid = _k1("launches")
    want = learn.expected_counts(plan, values, masks, device=cuda,
                                 dtype=torch.float64)
    assert _k1("launches") == mid  # float64 takes the plain version
    for c, w in zip(counts, want):
        np.testing.assert_allclose(c, w, rtol=1e-4, atol=1e-4)
    thetas, hist = learn.fit_mle_missing(plan, data, steps=3, device=cuda)
    assert hist[-1] > hist[0] and _k1("launches") > mid


@pytest.mark.cuda
def test_chain_program_under_grad_on_cuda(cuda, monkeypatch):
    """The chain program with a gradient (functional steps) equals its
    in-place value on the plain steps bit for bit on the card; the in-place
    value on the row kernel (``ops.chain_step``, the default there) is
    within float32 rounding of it (its rows' sums run in another order);
    and the chain learner steps."""
    from junctiontree_tpu_torch.learn_chain import (
        chain_masks_from_data, fit_mle_chain)
    from junctiontree_tpu_torch.models import chain_bn_model
    from junctiontree_tpu_torch.ops import chain_step
    from junctiontree_tpu_torch.scan_executor import (
        ChainLayout, chain_posterior_program)

    factors, sizes, values = chain_bn_model(60, card=3, seed=2)
    plan = jt.compile_plan(factors, sizes)
    layout = ChainLayout.detect(plan)
    eng = jt.Engine(plan, device=cuda).set_potentials(values)
    A = torch.tensor(jt.chain_stack_from_numpy(plan.to_json(), eng._pots_np),
                     dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 3, size=(32, 60))
    data[rng.random(data.shape) < 0.4] = -1
    M = torch.tensor(chain_masks_from_data(plan, layout, data), device=cuda)
    prog = chain_posterior_program(plan, layout)
    before = _count("chain_step.launches")
    postk, logzk = prog(A, M)
    assert _count("chain_step.launches") - before == 2 * len(
        layout.clique_order)
    with monkeypatch.context() as mp:
        mp.setattr(chain_step, "engages", lambda *a: False)
        post0, logz0 = prog(A, M)
    post1, logz1 = prog(A.clone().requires_grad_(True), M)
    assert post1.requires_grad
    assert torch.equal(post1.detach(), post0) and torch.equal(logz1.detach(), logz0)
    assert torch.equal(torch.isneginf(logzk), torch.isneginf(logz0))
    fin = torch.isfinite(logz0)
    assert (logzk[fin] - logz0[fin]).abs().max() <= 1e-4
    # each of the 59 steps' products and sums of K = 3 rounds within 4K u
    assert (postk - post0).abs().max() <= 59 * 4 * 3 * 2.0**-24
    _, hist = fit_mle_chain(plan, data, steps=3, device=cuda)
    assert hist[-1] > hist[0]


@pytest.mark.cuda
def test_cutset_on_cuda_impossible_rows_and_cpu_parity(cuda):
    from junctiontree_tpu_torch.models import grid_mrf_model

    factors, sizes, values = grid_mrf_model(4, 4, seed=0)
    names = list(sizes)
    cut = [names[5], names[10]]
    m = np.ones((4, 2), dtype=np.float32)
    m[1] = 0.0
    m[2] = [0.0, 1.0]
    on_cut = np.ones((4, 2), dtype=np.float32)
    on_cut[3] = 0.0
    masks = {names[0]: m, names[5]: on_cut}
    ce = jt.CutsetEngine(factors, sizes, values, cutset=cut, device=cuda,
                         state_chunk=3)
    ref = jt.CutsetEngine(factors, sizes, values, cutset=cut, device="cpu",
                          dtype=torch.float64)
    want, want_logz = ref.posterior_batch(masks)
    for mode in ("auto", "message", "fused"):
        got, logz = ce.posterior_batch(masks, mode=mode)
        assert logz.device.type == "cuda"
        assert bool(torch.isneginf(logz[1])) and bool(torch.isneginf(logz[3]))
        np.testing.assert_allclose(logz.cpu().numpy()[[0, 2]],
                                   want_logz.numpy()[[0, 2]], rtol=1e-5)
        for v in sizes:
            p = got[v].cpu().numpy()
            assert (p[[1, 3]] == 0).all() and not np.isnan(p).any(), (mode, v)
            np.testing.assert_allclose(p, want[v].numpy(), rtol=1e-4, atol=1e-6)
    a, s = ce.map_assignment_batch(masks)
    ra, rs = ref.map_assignment_batch(masks)
    np.testing.assert_allclose(s[[0, 2]], rs[[0, 2]], rtol=1e-5)
    assert s[1] < -1e29 and s[3] < -1e29


@pytest.mark.cuda
def test_sampler_is_deterministic_on_a_cuda_generator(cuda):
    from junctiontree_tpu_torch.models import sprinkler_model
    from junctiontree_tpu_torch.sampling import engine_sample

    f, s, v = sprinkler_model()
    tree = jt.create_junction_tree(f, s)
    eng = tree.engine(device=cuda).set_potentials(v)
    a = engine_sample(eng, torch.Generator(device=cuda).manual_seed(5), 20000)
    b = engine_sample(eng, 5, 20000)
    np.testing.assert_array_equal(a, b)
    post, _ = eng.query({})
    for vid in range(4):
        p = post[vid][1]
        assert abs(a[:, vid].mean() - p) <= 5 * np.sqrt(p * (1 - p) / 20000) + 1e-3
    with pytest.raises(ValueError, match="generator"):
        engine_sample(eng, torch.Generator().manual_seed(5), 10)


@pytest.mark.cuda
def test_mmap_loopy_and_chow_liu_on_cuda_match_cpu(cuda):
    from junctiontree_tpu_torch.models import grid_mrf_model

    factors, sizes, values = grid_mrf_model(4, 4, seed=3)
    names = list(sizes)
    B = 16
    plan = jt.compile_plan(factors, sizes)
    evs = jt.random_evidence_batch(plan, B, names[8:10], seed=1)
    masks = jt.batch_masks_sparse(plan, evs)
    lm = {k: np.where(m > 0, 0.0, -np.inf).astype(np.float32) for k, m in masks.items()}
    out = {}
    for dev in (cuda, "cpu"):
        solver = jt.MarginalMapSolver(factors, sizes, names[:4], device=dev)
        out[str(dev)] = solver.set_potentials(values).query_batch(lm)
    (a, s), (ca, cs) = out["cuda"], out["cpu"]
    assert a.device.type == "cuda" and a.dtype == torch.int32
    np.testing.assert_allclose(s.cpu().numpy(), cs.numpy(), rtol=1e-5)
    assert torch.equal(a.cpu(), ca)
    res = {}
    for dev in (cuda, "cpu"):
        eng = jt.LoopyEngine(factors, sizes, values, tol=0.0, max_iters=50, device=dev)
        res[str(dev)] = eng.posterior_batch(masks)
    (p, z, _), (cp, cz, _) = res["cuda"], res["cpu"]
    np.testing.assert_allclose(z.cpu().numpy(), cz.numpy(), rtol=1e-4, atol=1e-4)
    for v in range(len(names)):
        np.testing.assert_allclose(p[v].cpu().numpy(), cp[v].numpy(), atol=1e-4)
    data = np.random.default_rng(0).integers(0, 3, size=(500, 5))
    got = jt.chow_liu(data, device=cuda)
    want = jt.chow_liu(data, device="cpu")
    assert got[0] == want[0] and got[3] == want[3]
    for x, y in zip(got[2], want[2]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_tf32_process_setting_does_not_reach_the_package(cuda):
    """A process that allows TF32 (``set_float32_matmul_precision("high")``)
    still gets float64-grade posteriors from the package (rtol 1e-4, atol
    1e-6; logZ 1e-4), and keeps its own setting."""
    from junctiontree_tpu_torch.models import alarm_like

    factors, sizes, values = alarm_like(seed=0)
    tree = jt.create_junction_tree(factors, sizes)
    labels = [tree.plan.table.label_of(v) for v in range(tree.plan.num_vars)]
    masks = jt.batch_masks_sparse(
        tree.plan, jt.random_evidence_batch(tree.plan, 256, labels[::3], seed=3))
    ref_post, ref_logz = tree.engine(device=cuda, dtype=torch.float64) \
        .set_potentials(values).posterior_batch(masks)
    eng = tree.engine(device=cuda).set_potentials(values)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        post, logz = eng.posterior_batch(masks)
        torch.cuda.synchronize()
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved)
    np.testing.assert_allclose(logz.cpu().numpy(), ref_logz.cpu().numpy(), atol=1e-4)
    for a, b in zip(post, ref_post):
        np.testing.assert_allclose(a.double().cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_autotune_decision_on_a_serving_shape(cuda, monkeypatch):
    """One measured decision at the big clique's serving shape: both
    candidates timed (host and device ms), persisted under the card's name,
    the kernel's launch counts untouched; the library candidate agrees with
    the plain version (f32 1e-5, bf16 inputs 2e-2 of max|out|).  Whatever
    the table says, a big-clique ``posterior_batch`` then launches the
    kernel for every routed contraction."""
    from junctiontree_tpu_torch.ops import autotune

    monkeypatch.setattr(autotune, "_CACHE", None)
    monkeypatch.setattr(autotune, "_VALIDATED", set())
    assert DEFAULT.autotune  # the package default
    before = (_k1("launches"), _k1("launches_bf16"))
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        winner = autotune.decide(64, 2048, 2, 4096, dtype=name, device=cuda)
        key = f"{name}:64x2048x2:B4096:{torch.cuda.get_device_name(cuda)}"
        ent = autotune.report()[key]
        assert winner == ent["winner"] in ("k1", "library")
        for field in ("k1_ms", "library_ms", "k1_device_ms", "library_device_ms"):
            assert ent[field] > 0, field
        assert ent["bound_ms"] > 0 and ent["margin"] >= 1.0
        g = torch.Generator(device=cuda).manual_seed(1)
        pot = torch.rand((2048, 64, 2), generator=g, device=cuda).to(dtype) \
            .permute(1, 0, 2)
        w1 = torch.rand((4096, 64), generator=g, device=cuda)
        w2 = torch.rand((4096, 2048), generator=g, device=cuda).to(dtype)
        got = fc.library_factored_contract(pot, w1, w2)
        assert got.dtype == torch.float32
        assert _rel_err(got, fc.reference_factored_contract(pot, w1, w2)) <= _tol(dtype)
    assert (_k1("launches"), _k1("launches_bf16")) == before
    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    factors, sizes, values = _hub_model()
    tree = jt.create_junction_tree(factors, sizes)
    masks = jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, 64, ["t0", "t1", "h5"], seed=3))
    for dtype in (torch.float32, torch.bfloat16):
        eng = tree.engine(device=cuda, dtype=dtype).set_potentials(values)
        launches = _k1("launches")  # bf16 launches included
        calls = _count("big_clique_sep_message.calls")
        eng.posterior_batch(masks)
        routed = _count("big_clique_sep_message.calls") - calls
        assert _k1("launches") - launches == routed > 0


@pytest.mark.cuda
def test_native_compile_on_the_card_host(cuda):
    """The C++ plan compiler builds with this machine's ``g++`` and gives
    the Python compiler's plan on the chain of 5,000."""
    from junctiontree_tpu_torch import native
    from junctiontree_tpu_torch.models import chain_bn_model

    assert native.available()
    factors, sizes, _ = chain_bn_model(5000, seed=1)
    assert jt.compile_plan(factors, sizes).to_json() == jt.compile_plan(
        factors, sizes, backend="python").to_json()


@pytest.mark.cuda
def test_cli_on_cuda_matches_cpu(cuda, tmp_path, capsys):
    """``python -m junctiontree_tpu_torch`` on the card prints the CPU run's
    numbers (MAR and PR, atol 1e-5)."""
    from junctiontree_tpu_torch import __main__ as cli
    from junctiontree_tpu_torch.models import grid_mrf_model
    from junctiontree_tpu_torch.utils.uai import write_uai

    factors, sizes, values = grid_mrf_model(3, 3, seed=4)
    names = list(sizes)
    model = tmp_path / "m.uai"
    model.write_text(write_uai([[names.index(v) for v in f] for f in factors],
                               {i: sizes[v] for i, v in enumerate(names)}, values))
    evid = tmp_path / "m.evid"
    evid.write_text("1 4 1\n")
    for task in ("MAR", "PR"):
        out = {}
        for dev in ("cuda", "cpu"):
            assert cli.main([str(model), "--evidence", str(evid), "--task", task,
                             "--device", dev]) == 0
            out[dev] = capsys.readouterr().out.splitlines()
        assert out["cuda"][0] == out["cpu"][0] == task
        np.testing.assert_allclose(
            [float(t) for t in out["cuda"][1].split()],
            [float(t) for t in out["cpu"][1].split()], atol=1e-5)


def _mesh_devices(n):
    """n mesh positions over the cards there are: distinct cards where
    there are n of them, cuda:0 repeated on one card."""
    return [torch.device("cuda", i % torch.cuda.device_count())
            for i in range(n)]


def _launches_of(fn):
    before = _k1("launches")
    out = fn()
    torch.cuda.synchronize()
    return out, _k1("launches") - before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_on_one_card_launches_kernel_per_shard(cuda, dtype, monkeypatch):
    """``shard_model`` over a mesh of 4 card positions: every routed
    contraction of the hub (2^12 states, thresholds lowered to 2^8) launches
    the kernel once per model shard, 4 times the unsharded engine's
    launches, and the results equal the unsharded engine's (f32 1e-5, bf16
    within 2e-2 of it) with no gathered contraction.  A float32 shard's
    launch of at most 32 columns takes the narrow CUDA-core kernel's
    narrowest column tile that holds them; any other launch reads all its
    columns (up to 128) in one tile."""
    from junctiontree_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(DEFAULT, "big_clique_min_states", 1 << 8)
    configs = []
    launch_config = fc.launch_config

    def recording(B, R1, R2, C, *args, **kw):
        cfg = launch_config(B, R1, R2, C, *args, **kw)
        configs.append((R1, C, cfg))
        return cfg

    monkeypatch.setattr(fc, "launch_config", recording)
    factors, sizes, values = _hub_model()
    plan = jt.compile_plan(factors, sizes)
    evs = jt.random_evidence_batch(plan, 256, ["t0", "t1", "h5", "h6"], seed=2)
    masks = jt.batch_masks_sparse(plan, evs)
    eng0 = jt.Engine(plan, device=cuda, dtype=dtype).set_potentials(values)
    (post0, logz0), n0 = _launches_of(lambda: eng0.posterior_batch(masks))
    for n_batch, shard_batch in ((1, False), (2, True)):
        mesh = make_mesh(n_batch, 4 // n_batch, devices=_mesh_devices(4))
        eng = jt.Engine(plan, device=cuda, dtype=dtype)
        eng.shard_model(mesh, min_states=1 << 8, shard_batch=shard_batch)
        eng.set_potentials(values)
        configs.clear()
        (post, logz), n = _launches_of(lambda: eng.posterior_batch(masks))
        assert n0 > 0 and n == 4 * n0 == len(configs)
        for R1, C, cfg in configs:
            if dtype == torch.float32 and cfg["by_n"] and R1 * C <= 32:
                # the narrow CUDA-core kernel
                want = next(w for w in (16, 32) if R1 * C <= w)
                assert cfg["src"] == "fma" and cfg["bn"] == want
                assert cfg["bm"] * cfg["bn"] == 8192
            elif cfg["by_n"]:
                assert cfg["n_n"] == 1 or R1 * C > 128
        assert any(cfg["bn"] < 64 for _, _, cfg in configs) == (
            dtype == torch.float32 and any(R1 * C <= 32 for R1, C, _ in configs))
        assert eng.describe()["tp_fallbacks"] == []
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(logz.cpu(), logz0.cpu(), rtol=tol, atol=tol)
        for p, p0 in zip(post, post0):
            np.testing.assert_allclose(p.cpu(), p0.cpu(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_parallel_surface_on_the_cards(cuda):
    """The log-depth chain program over 4 card positions against the
    sequential program (f32, rtol 1e-4), ``shard_batch`` over 2 with
    ``chunk=`` against the unsharded engine, and the forest engine and loopy
    BP over them against one engine."""
    from junctiontree_tpu_torch.models import chain_bn_model, grid_mrf_model
    from junctiontree_tpu_torch.parallel import make_mesh

    factors, sizes, values = chain_bn_model(300, seed=1)
    plan = jt.compile_plan(factors, sizes)
    evs = jt.random_evidence_batch(plan, 64, [f"x{i}" for i in range(0, 300, 30)],
                                   seed=3)
    masks = jt.batch_masks_sparse(plan, evs)
    seq = jt.Engine(plan, device=cuda).set_potentials(values)
    par = jt.Engine(plan, device=cuda).set_potentials(values).shard_sequence(
        make_mesh(4, devices=_mesh_devices(4)), min_len=16)
    post0, logz0 = seq.posterior_batch(masks)
    post, logz = par.posterior_batch(masks)
    assert ("chain_parallel",) in par._programs and len(par._chain_A) == 4
    np.testing.assert_allclose(logz.cpu(), logz0.cpu(), rtol=1e-4)
    np.testing.assert_allclose(post.stacked.cpu(), post0.stacked.cpu(),
                               rtol=1e-4, atol=1e-6)

    factors, sizes, values = grid_mrf_model(4, 4, seed=0)
    plan = jt.compile_plan(factors, sizes)
    masks = jt.batch_masks_sparse(plan, jt.random_evidence_batch(
        plan, 100, ["g0_0", "g3_3"], seed=1))
    eng0 = jt.Engine(plan, device=cuda).set_potentials(values)
    eng = jt.Engine(plan, device=cuda).set_potentials(values).shard_batch(
        make_mesh(2, devices=_mesh_devices(2)))
    (p0, l0), (p1, l1) = eng0.posterior_batch(masks), eng.posterior_batch(
        masks, chunk=16)
    np.testing.assert_allclose(l1.cpu(), l0.cpu(), rtol=1e-5)
    for a, b in zip(p1, p0):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-5, atol=1e-7)

    from junctiontree_tpu_torch.parallel.forest import ForestEngine

    factors2 = factors + [["h", "i"], ["z"]]
    sizes2 = dict(sizes, h=3, i=2, z=4)
    rng = np.random.default_rng(0)
    values2 = list(values) + [rng.random((3, 2)) + 0.1, rng.random(4) + 0.1]
    evs = [{"g0_0": 1, "i": 0}, {"z": 2}, {}]
    fpost, flogz = ForestEngine(factors2, sizes2, devices=_mesh_devices(3)) \
        .set_potentials(values2).posterior_batch(evs)
    plan2 = jt.compile_plan(factors2, sizes2)
    mpost, mlogz = jt.Engine(plan2, device=cuda).set_potentials(values2) \
        .posterior_batch(jt.batch_masks_sparse(plan2, evs))
    np.testing.assert_allclose(flogz.cpu(), mlogz.cpu(), rtol=1e-5)
    for v in sizes2:
        np.testing.assert_allclose(fpost[v].cpu(),
                                   mpost[plan2.table.id_of(v)].cpu(),
                                   rtol=1e-5, atol=1e-6)
    lmasks = {k: v for k, v in masks.items()}
    one = jt.LoopyEngine(factors, sizes, values, device=cuda, tol=1e-5)
    split = jt.LoopyEngine(factors, sizes, values, tol=1e-5,
                           mesh=make_mesh(4, devices=_mesh_devices(4)))
    q1, z1, i1 = one.posterior_batch(lmasks)
    q2, z2, i2 = split.posterior_batch(lmasks)
    assert i1["iters"] == i2["iters"]
    np.testing.assert_allclose(z2.cpu(), z1.cpu(), atol=1e-4)


# -- the in-kernel sum of the r2 partials, and the kept pot operands -------


# (R1, R2, C, B) whose r2 sum leaves several partials a tile: joints over 2
# and 3 variables, the E-step forward, both model shards (narrow f32 tiles),
# a B that is not a multiple of 128, more tiles than SMs, the "c" tiling at
# a small B (its r2 over several clusters where the card's slots allow),
# and B * C or C not a multiple of 4 (the sum's float4 loads do not fit)
SPLIT_SUM_SHAPES = [(64, 1024, 4, 4096), (64, 512, 8, 4096),
                    (512, 512, 1, 4096), (512, 256, 2, 4096),
                    (16, 2048, 2, 4096), (16, 4096, 1, 4096),
                    (64, 512, 8, 4000), (16, 2048, 2, 4000),
                    (64, 512, 8, 32768), (2, 4096, 64, 512),
                    (512, 512, 1, 4001), (2, 4096, 66, 512)]


def _operands(cuda, R1, R2, C, B, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed + R1 + R2 + C + B)
    if fc.tiles_by_n(C):  # the layout the route hands over
        pot = torch.rand((R2, R1, C), generator=g, device=cuda).permute(1, 0, 2)
    else:
        pot = torch.rand((R1, R2, C), generator=g, device=cuda)
    w1 = torch.rand((B, R1), generator=g, device=cuda)
    w2 = torch.rand((B, R2), generator=g, device=cuda)
    return pot.to(dtype), w1, w2.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("R1,R2,C,B", SPLIT_SUM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_kernel_sum_is_repeatable_and_close(cuda, R1, R2, C, B, dtype):
    """Where the last block of a tile adds the partials, the bits do not
    depend on which block came last: 20 runs, and runs on two streams at
    once, give the same bits; within 2e-6 of max|out| of the plain
    version.  The shapes named for it have several partials a tile."""
    pot, w1, w2 = _operands(cuda, R1, R2, C, B, dtype)
    cfg = fc.launch_config(
        B, R1, R2, C, fc._sm_count(pot.device), dtype == torch.bfloat16,
        functools.partial(fc._cluster_slots, pot.device, fc.source(
            dtype == torch.bfloat16, "highest",
            R1 * C if fc.tiles_by_n(C) else None)))
    if fc.tiles_by_n(C) and (cfg["n_n"] > 1 or cfg["src"] == "fma"):
        assert cfg["nparts"] > 1, cfg
    k1 = fc.factored_masked_contract
    first = k1(pot, w1, w2)
    runs = [k1(pot, w1, w2) for _ in range(19)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    on_streams = []
    for s in streams:
        with torch.cuda.stream(s):
            on_streams.append([k1(pot, w1, w2) for _ in range(5)])
    torch.cuda.synchronize()
    assert all(torch.equal(first, r) for r in runs)
    assert all(torch.equal(first, r) for rs in on_streams for r in rs)
    assert _rel_err(first, fc.reference_factored_contract(pot, w1, w2)) <= 2e-6


@pytest.mark.cuda
def test_in_kernel_sum_gradients_unchanged(cuda):
    """The E-step's forward shape (512, 256, 2) leaves 8 partials a tile:
    the Function's gradients stay within 1e-6 of max|grad| of the plain
    version's."""
    pot, w1, w2 = _operands(cuda, 512, 256, 2, 4096, torch.float32, seed=1)
    up = torch.rand((4096, 2), device=cuda)
    leaves = [t.detach().clone().requires_grad_(True) for t in (pot, w1, w2)]
    got = torch.autograd.grad(fc.factored_masked_contract(*leaves), leaves, up)
    want = fc.factored_contract_grads(pot, w1, w2, up)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 1e-6


def _big_clique_engine(cuda, dtype=torch.float32, B=512, seed=0):
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(18)]
    factors = [names[:]] + [[v] for v in names]
    values = [rng.random((2,) * 18) + 0.1] + [rng.random(2) + 0.1
                                               for _ in names]
    tree = jt.create_junction_tree(factors, {v: 2 for v in names})
    masks = jt.batch_masks_sparse(
        tree.plan, jt.random_evidence_batch(tree.plan, B, names[:12], seed=1))
    return tree, values, masks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_standing_potential_is_split_once(cuda, dtype):
    """The big clique's 19 routed contractions split (float32) or permute
    (bfloat16) the standing potential on an engine's first call, and read
    what was kept on the next: 19 splits, then 0, and 19 kept operands
    found; the two calls give the same bits."""
    tree, values, masks = _big_clique_engine(cuda)
    eng = tree.engine(device=cuda, dtype=dtype).set_potentials(values)
    splits, misses = _k1("splits"), _count("kept.misses")
    first = eng.posterior_batch(masks)
    torch.cuda.synchronize()
    assert _count("kept.misses") - misses == 19
    assert _k1("splits") - splits == (19 if dtype == torch.float32 else 0)
    splits, hits = _k1("splits"), _count("kept.hits")
    second = eng.posterior_batch(masks)
    torch.cuda.synchronize()
    assert _k1("splits") == splits and _count("kept.hits") - hits == 19
    assert torch.equal(first[1], second[1])
    assert all(torch.equal(a, b) for a, b in zip(first[0], second[0]))
    rep = eng.describe()["kept_layouts"]
    per_state = 6 if dtype == torch.float32 else 2
    assert rep["layouts"] == 19
    assert 19 * per_state * (1 << 18) <= rep["bytes"] <= eng._kept_bytes_bound()


@pytest.mark.cuda
def test_kept_operands_follow_the_engines_potentials(cuda, tmp_path):
    """After ``set_potentials`` with new values, ``multiply_factor`` and
    ``load``, a live engine that kept its operands gives what a freshly
    built engine gives, bit for bit; an in-place edit of the standing
    tensor is seen too."""
    tree, values, masks = _big_clique_engine(cuda, seed=2)
    eng = tree.engine(device=cuda).set_potentials(values)
    eng.posterior_batch(masks)

    def same(a, b):
        return torch.equal(a[1], b[1]) and all(
            torch.equal(x, y) for x, y in zip(a[0], b[0]))

    new = [v * np.linspace(0.5, 1.5, v.size).reshape(v.shape) for v in values]
    eng.set_potentials(new)
    fresh = tree.engine(device=cuda).set_potentials(new)
    assert same(eng.posterior_batch(masks), fresh.posterior_batch(masks))
    factor = np.array([[1.0, 3.0], [0.5, 2.0]])
    eng.multiply_factor(["v3", "v9"], factor)
    fresh.multiply_factor(["v3", "v9"], factor)
    got = eng.posterior_batch(masks)
    assert same(got, fresh.posterior_batch(masks))
    path = str(tmp_path / "big.npz")
    eng.save(path)
    loaded = jt.Engine.load(path, device=cuda)
    loaded.posterior_batch(masks)
    assert same(loaded.posterior_batch(masks), got)
    eng._pots[0].mul_(2.0)  # logZ moves by log 2, posteriors stay
    _, logz = eng.posterior_batch(masks)
    fin = torch.isfinite(got[1])
    torch.testing.assert_close(logz[fin], got[1][fin] + np.log(2.0),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kept_operand_read_on_another_stream(cuda):
    """An operand kept on one stream and read on another (waited for by an
    event) gives the bits of the first stream's call."""
    pot, w1, w2 = _operands(cuda, 64, 2048, 2, 4096, torch.float32, seed=3)
    rows = pot.permute(1, 0, 2).contiguous().view(2048, 64, 2)
    fc.standing(rows, 1)
    lay = fc.StandingLayout(rows, [1], [0], [2], True)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()  # the operands are made on the default stream
    hits = _count("kept.hits")
    with torch.cuda.stream(s1):
        a = fc.factored_masked_contract(lay, w1, w2)
    with torch.cuda.stream(s2):
        b = fc.factored_masked_contract(lay, w1, w2)
    torch.cuda.synchronize()
    assert _count("kept.hits") == hits + 1  # s2 read what s1 kept
    assert torch.equal(a, b)
    assert torch.equal(a, fc.factored_masked_contract(lay.tensor(), w1, w2))


def _same(a, b):
    """Bitwise equal ``(tensors or tensor, tensor)`` results."""
    if isinstance(a[0], torch.Tensor):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    return torch.equal(a[1], b[1]) and all(
        torch.equal(x, y) for x, y in zip(a[0], b[0]))


@pytest.mark.cuda
def test_serving_under_inference_mode(cuda):
    """Under ``torch.inference_mode()``, the usual way to serve,
    ``posterior_batch`` and ``entropy_batch`` give the bits they give
    outside it: on an engine set outside (its kept operands are used) and
    on one set inside, whose potentials are inference tensors with no
    version counter (nothing is kept for them: every call splits).  A
    steady ``entropy_batch`` splits only its derived tensor, and keeps
    nothing for it."""
    tree, values, masks = _big_clique_engine(cuda, seed=4)
    eng = tree.engine(device=cuda).set_potentials(values)
    want = eng.posterior_batch(masks), eng.entropy_batch(masks)
    with torch.inference_mode():
        got = eng.posterior_batch(masks)
        splits, entries = _k1("splits"), len(fc._KEPT)
        h = eng.entropy_batch(masks)
        assert _k1("splits") - splits == 1 and len(fc._KEPT) == entries
        inf = tree.engine(device=cuda).set_potentials(values)
        assert all(p.is_inference() for p in inf._pots)
        splits = _k1("splits")
        got_inf = inf.posterior_batch(masks)
        assert _k1("splits") - splits == 19
        h_inf = inf.entropy_batch(masks)
        assert inf.describe()["kept_layouts"] == {"layouts": 0, "bytes": 0}
    torch.cuda.synchronize()
    assert _same(got, want[0]) and _same(got_inf, want[0])
    assert _same(h, want[1]) and _same(h_inf, want[1])
    splits = _k1("splits")
    assert _same(inf.posterior_batch(masks), want[0])  # outside the mode too
    assert _k1("splits") - splits == 19


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kept_layouts_follow_the_evidence_pattern(cuda, dtype):
    """Alternating two and then three evidence patterns (evidence on 12,
    2 and 1 of the clique's variables), then staying on the last: a call
    that repeats the last call's pattern splits nothing; under alternation
    the first pattern's layouts stay kept and the other's calls split
    (float32) what they lack; a pattern that stays is kept.  What is kept
    never exceeds one call's 19 layouts nor ``_kept_bytes_bound``, and
    every call gives the bits of an engine that saw only its pattern."""
    tree, values, masks = _big_clique_engine(cuda, seed=5, B=256)
    names = [f"v{i}" for i in range(18)]
    pats = [masks] + [jt.batch_masks_sparse(tree.plan, jt.random_evidence_batch(
        tree.plan, 256, obs, seed=6)) for obs in (names[16:], names[5:6])]
    want = [tree.engine(device=cuda, dtype=dtype).set_potentials(values)
            .posterior_batch(m) for m in pats]
    eng = tree.engine(device=cuda, dtype=dtype).set_potentials(values)
    bound = eng._kept_bytes_bound()
    order = [0, 0, 1, 0, 1, 0, 1, 2, 0, 1, 2] + [2] * 20
    made, splits = [], []
    for i in order:
        misses, split = _count("kept.misses"), _k1("splits")
        assert _same(eng.posterior_batch(pats[i]), want[i])
        made.append(_count("kept.misses") - misses)
        splits.append(_k1("splits") - split)
        now = eng.describe()["kept_layouts"]
        assert 0 < now["layouts"] <= 19 and now["bytes"] <= bound
    assert made[0] == 19 and made[1] == made[3] == made[5] == made[-1] == 0
    assert all(m <= 19 for m in made)
    assert splits == (made if dtype == torch.float32 else [0] * len(made))
