"""The factored big-clique contraction: the port's plain version against the
JAX package's Pallas kernel (interpret mode) and its einsum reference, the
surrounding weight-group logic against JAX ``big_clique_sep_message``, the
CUDA kernel's launch arithmetic, and a plain-torch emulation of its tiling.
The CUDA kernel itself is tested on the GPU by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from junctiontree_tpu.ops import pallas_contract as jax_pc
from junctiontree_tpu_torch.ops import factored_contract as fc
from junctiontree_tpu_torch.utils.timing import TIMERS


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize(
    "R1,R2,C,B", [(4, 8, 3, 5), (8, 128, 128, 256), (3, 50, 17, 33)]
)
def test_plain_matches_jax_kernel(R1, R2, C, B):
    rng = np.random.default_rng(R1 + R2 + C + B)
    pot = rng.random((R1, R2, C)).astype(np.float32)
    w1 = rng.random((B, R1)).astype(np.float32)
    w2 = rng.random((B, R2)).astype(np.float32)
    got = fc.factored_masked_contract(_t(pot), _t(w1), _t(w2))
    assert got.dtype == torch.float32
    kern = jax_pc.factored_masked_contract(
        jnp.asarray(pot), jnp.asarray(w1), jnp.asarray(w2), interpret=True
    )
    ref = jax_pc.reference_factored_contract(
        jnp.asarray(pot), jnp.asarray(w1), jnp.asarray(w2)
    )
    for want in (kern, ref):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5
        )


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_precision_argument_matches_jax_kernel(precision):
    """The TPU kernel's ``precision`` argument: on the CPU both values give
    the exact result, as the JAX kernel's do in interpret mode (XLA on the
    CPU ignores the precision), and any other string raises on every
    device, before anything runs."""
    rng = np.random.default_rng(21)
    pot, w1, w2 = (rng.random(s).astype(np.float32)
                   for s in ((3, 50, 17), (33, 3), (33, 50)))
    got = fc.factored_masked_contract(_t(pot), _t(w1), _t(w2),
                                      precision=precision)
    kern = jax_pc.factored_masked_contract(
        jnp.asarray(pot), jnp.asarray(w1), jnp.asarray(w2), interpret=True,
        precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-5,
                               atol=1e-6)
    for bad in ("high", "HIGHEST", "tf32"):
        with pytest.raises(ValueError, match="precision"):
            fc.factored_masked_contract(_t(pot), _t(w1), _t(w2), precision=bad)
    leaf = _t(pot).requires_grad_(True)  # the autograd path checks it too
    with pytest.raises(ValueError, match="precision"):
        fc.factored_masked_contract(leaf, _t(w1), _t(w2), precision="high")


@pytest.mark.parametrize("R1,R2,C,B", [(4, 8, 3, 5), (8, 128, 128, 256)])
def test_plain_bf16_inputs_f32_accumulation(R1, R2, C, B):
    rng = np.random.default_rng(R1 + R2 + C + B + 1)
    pot = rng.random((R1, R2, C)).astype(np.float32)
    w1 = rng.random((B, R1)).astype(np.float32)
    w2 = rng.random((B, R2)).astype(np.float32)
    got = fc.factored_masked_contract(
        _t(pot, torch.bfloat16), _t(w1, torch.bfloat16),
        _t(w2, torch.bfloat16),
    )
    assert got.dtype == torch.float32
    want = jax_pc.reference_factored_contract(
        jnp.asarray(pot), jnp.asarray(w1), jnp.asarray(w2)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2)


def test_build_weight_groups_matches_jax():
    rng = np.random.default_rng(0)
    masks = [rng.random((7, k)).astype(np.float32) for k in (2, 3, 4, 2, 5)]
    w1, w2, g1, g2 = fc.build_weight_groups([_t(m) for m in masks])
    jw1, jw2, jg1, jg2 = jax_pc.build_weight_groups(
        [jnp.asarray(m) for m in masks]
    )
    assert (g1, g2) == (jg1, jg2)
    np.testing.assert_allclose(w1.numpy(), np.asarray(jw1), rtol=1e-6)
    np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), rtol=1e-6)


def _sep_message_case(name):
    """(pot, clique vars, masks, sep vars, msgs) as numpy f32, mirroring the
    JAX package's own big_clique_sep_message tests."""
    if name == "masks":
        rng = np.random.default_rng(3)
        cvars, svars = [10, 11, 12, 13, 14], [13, 14]
        sizes = {10: 2, 11: 3, 12: 2, 13: 4, 14: 3}
        pot = rng.random(tuple(sizes[v] for v in cvars))
        masks = {10: rng.random((9, 2)), 12: rng.random((9, 2)),
                 14: rng.random((9, 3))}
        return pot, cvars, masks, svars, []
    if name == "no_rest_masks":
        rng = np.random.default_rng(5)
        return rng.random((2, 3, 4)), [0, 1, 2], {2: rng.random((6, 4))}, [2], []
    rng = np.random.default_rng(11)
    cvars, svars = [0, 1, 2, 3, 4, 5], [4, 5]
    sizes = {0: 2, 1: 3, 2: 2, 3: 4, 4: 3, 5: 2}
    pot = rng.random(tuple(sizes[v] for v in cvars))
    masks = {0: rng.random((7, 2)), 4: rng.random((7, 3))}
    m45 = rng.random((7, 3, 2))
    msgs = [((1, 2), rng.random((7, 3, 2))), ((2, 3), rng.random((7, 2, 4)))]
    if name == "messages":
        msgs.append(((4, 5), m45))
    else:  # a separator-scoped message in reversed variable order
        msgs.append(((5, 4), np.transpose(m45, (0, 2, 1))))
    return pot, cvars, masks, svars, msgs


@pytest.mark.parametrize(
    "name", ["masks", "no_rest_masks", "messages", "messages_reversed"]
)
def test_big_clique_sep_message_matches_jax(name):
    pot, cvars, masks, svars, msgs = _sep_message_case(name)
    f32 = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
    got = fc.big_clique_sep_message(
        _t(pot), cvars, {v: _t(m) for v, m in masks.items()}, svars,
        msgs=[(vs, _t(m)) for vs, m in msgs],
    )
    want = jax_pc.big_clique_sep_message(
        jnp.asarray(f32(pot)), cvars,
        {v: jnp.asarray(f32(m)) for v, m in masks.items()}, svars,
        msgs=[(vs, jnp.asarray(f32(m))) for vs, m in msgs], interpret=True,
    )
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6
    )


def test_big_clique_message_crossing_boundary_raises():
    rng = np.random.default_rng(13)
    pot = _t(rng.random((2, 3, 4)))
    msg = _t(rng.random((5, 3, 4)))
    with pytest.raises(ValueError, match="crosses"):
        fc.big_clique_sep_message(pot, [0, 1, 2], {}, [2], msgs=[((1, 2), msg)])


SERVING_SHAPES = [(4096, 64, 2048, 2), (4096, 64, 4096, 1)]
# one model shard of each (Engine.shard_model over 4 model shards)
SHARD_SHAPES = [(4096, 16, 2048, 2), (4096, 16, 4096, 1)]
EDGE_SHAPES = [(5, 1, 37, 1), (33, 3, 50, 17), (130, 5, 70, 300),
               (4097, 64, 4095, 1), (70000, 2, 40, 3),
               # the weight gradients at the serving shape: dw2 ("c" tiling,
               # 1,024 tiles walked by one wave) and dw1
               (4096, 2, 64, 2048), (4096, 2, 2048, 64)]
# clusters of 1..8 blocks that an H100 SXM holds at once, as
# cudaOccupancyMaxActiveClusters reported them on the card (the same for
# the bf16 and the f32 kernels)
H100_CLUSTER_SLOTS = (132, 66, 39, 30, 22, 17, 15, 15)


def _blocks(cfg):
    """(row tile, column tile, split z) of every tile that every block
    takes, decoded as the kernel decodes blockIdx.x: ((first tile * kparts
    + part) * nsplit + rank, z = part * nsplit + rank; a block takes the
    tiles first, first + stride, ... with stride = grid / (kparts *
    nsplit), one unless the grid is a wave that walks the tiles."""
    if cfg["src"] == "fma":  # split * n_b + row tile
        for bid in range(cfg["grid"]):
            split, bt = divmod(bid, cfg["n_b"])
            yield bt, 0, split
        return
    per = cfg["kparts"] * cfg["nsplit"]
    for bid in range(cfg["grid"]):
        rest, rank = divmod(bid, cfg["nsplit"])
        first, part = divmod(rest, cfg["kparts"])
        for tile in range(first, cfg["n_b"] * cfg["n_n"], cfg["grid"] // per):
            nt, bt = divmod(tile, cfg["n_b"])
            yield bt, nt, part * cfg["nsplit"] + rank


def _r2_steps(cfg, z, R2):
    """The r2 steps of ``bk`` that split z of a tile walks: z, z + S, ...
    with S = kparts * nsplit (the narrow f32 kernel: a contiguous range of
    k_per_split)."""
    n_k = -(-R2 // cfg["bk"])
    if cfg["src"] == "fma":
        per = cfg["k_per_split"] // cfg["bk"]
        return range(z * per, min(n_k, (z + 1) * per))
    return range(z, n_k, cfg["kparts"] * cfg["nsplit"])


def _check_launch_config(B, R1, R2, C, n_sm, bf16, slots=None,
                         precision="highest"):
    """The blocks, decoded as the kernel decodes them, cover every row,
    column and r2 step exactly once, within CUDA's limits and the block's
    227 KB of shared memory."""
    cfg = fc.launch_config(B, R1, R2, C, n_sm, bf16,
                           None if slots is None else lambda bn, by_n: slots,
                           precision)
    by_n = cfg["by_n"]
    assert by_n == fc.tiles_by_n(C) == (C <= 32) and cfg["bf16"] == bf16
    ncols = R1 * C if by_n else C
    n_k = -(-R2 // cfg["bk"])
    if not bf16 and by_n and ncols <= 32:
        # narrow float32 products (the model shards): the CUDA-core kernel,
        # the narrowest column tile that holds N, 8192 accumulators, r2
        # split into contiguous ranges until the card is full
        assert cfg["src"] == "fma" and cfg["bn"] == (16 if ncols <= 16 else 32)
        assert cfg["bm"] * cfg["bn"] == 8192 and cfg["n_n"] == 1
        assert cfg["bk"] == 16 and cfg["k_per_split"] % 16 == 0
        assert cfg["nparts"] == cfg["nsplit"] and cfg["kparts"] == 1
        assert cfg["smem_bytes"] == fc.fma_smem_bytes(cfg["bn"]) <= 232_448
        assert cfg["blocks_per_sm"] == min(
            2, fc.SMEM_PER_SM // (cfg["smem_bytes"] + 1024))
        if cfg["nsplit"] > 1:  # r2 is split only to fill one wave
            assert cfg["grid"] <= cfg["blocks_per_sm"] * n_sm
        assert (cfg["n_b"] - 1) * cfg["bm"] < B <= cfg["n_b"] * cfg["bm"]
        assert cfg["grid"] == cfg["n_b"] * cfg["nsplit"]
        steps = [s for z in range(cfg["nsplit"]) for s in _r2_steps(cfg, z, R2)]
        assert all(len(_r2_steps(cfg, z, R2)) > 0 for z in range(cfg["nsplit"]))
        assert sorted(steps) == list(range(n_k))
        blocks = list(_blocks(cfg))
        assert len(set(blocks)) == cfg["grid"]
        return cfg
    src = "bf16" if bf16 else {"highest": "f32x6", "default": "f32x1"}[precision]
    assert cfg["src"] == src and cfg["planes"] == (3 if src == "f32x6" else 1)
    # a stage is one 128-byte row of w2: 64 bf16 or 32 f32 r2
    assert (cfg["bm"], cfg["bk"]) == (128, 64 if bf16 else 32)
    # all of N <= 128 in one tile: w2 is read once
    assert cfg["bn"] == (128 if by_n and ncols > 64 else 64)
    assert cfg["k_per_split"] == cfg["bk"]
    splits = cfg["kparts"] * cfg["nsplit"]
    assert 1 <= cfg["nsplit"] <= 8 and 1 <= splits <= n_k
    assert cfg["nparts"] == cfg["kparts"] * (cfg["n_n"] if by_n else 1)
    assert cfg["blocks_per_sm"] == 1
    have = slots or [n_sm // size for size in range(1, 9)]
    tiles = cfg["n_b"] * cfg["n_n"]
    if tiles * cfg["kparts"] > have[cfg["nsplit"] - 1]:
        assert (cfg["nsplit"], cfg["kparts"]) == (1, 1)  # no cluster fits
    if bf16:
        # one cluster along r2, the largest whose tiles' clusters are all
        # resident at once
        fits = [size for size in range(1, min(8, n_k) + 1)
                if have[size - 1] >= tiles]
        assert cfg["kparts"] == 1 and cfg["nsplit"] == max(fits, default=1)
    else:
        # r2 splits that fill one wave of blocks, in clusters that are all
        # resident at once; of those, the most blocks, then the largest
        # cluster
        want = max(1, min(n_k, n_sm // tiles))
        assert splits <= want
        for size in range(1, 9):
            k = min(want // size, have[size - 1] // tiles)
            assert k == 0 or (size * k, size) <= (splits, cfg["nsplit"])
    # the ring: w2 tile [128, 128 bytes] and per bf16 plane bn / 64 boxes
    # [bk, 64] a stage, at least 4 stages deep, in 192 KB (bf16) or 200 KB
    stage = 128 * 128 + cfg["planes"] * cfg["bn"] // 64 * cfg["bk"] * 128
    assert cfg["stages"] == (192 if bf16 else 200) * 1024 // stage >= 4
    assert cfg["smem_bytes"] == cfg["stages"] * (stage + 16) + 1024
    assert cfg["smem_bytes"] == fc.smem_bytes(cfg["bn"], src)
    assert cfg["smem_bytes"] <= fc.MAX_SMEM_PER_BLOCK == 232_448
    for n_tiles, tile, extent in ((cfg["n_b"], cfg["bm"], B),
                                  (cfg["n_n"], cfg["bn"], ncols)):
        # ranges [i * tile, min((i + 1) * tile, extent)) are non-empty,
        # disjoint, and end at extent: every index lies in exactly one
        assert (n_tiles - 1) * tile < extent <= n_tiles * tile
    if not by_n and splits == 1 and tiles > n_sm:
        assert cfg["grid"] == n_sm  # one wave of blocks walks the tiles
    else:
        assert cfg["grid"] == tiles * splits
    assert 1 <= cfg["grid"] <= fc.MAX_GRID_X
    # every split walks at least one step, and the splits of a tile walk
    # every step exactly once
    steps = [s for z in range(splits) for s in _r2_steps(cfg, z, R2)]
    assert all(len(_r2_steps(cfg, z, R2)) > 0 for z in range(splits))
    assert sorted(steps) == list(range(n_k))
    if tiles * splits <= 1 << 16:
        blocks = list(_blocks(cfg))
        assert len(blocks) == len(set(blocks)) == tiles * splits
        assert set(blocks) == {(bt, nt, z) for bt in range(cfg["n_b"])
                               for nt in range(cfg["n_n"])
                               for z in range(splits)}
    return cfg


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,R1,R2,C", SERVING_SHAPES + SHARD_SHAPES + EDGE_SHAPES)
def test_launch_config_covers_every_output_and_r2(B, R1, R2, C, bf16):
    cfg = _check_launch_config(B, R1, R2, C, 132, bf16)
    if (B, R1, R2, C) in SHARD_SHAPES and not bf16:
        # the narrow f32 kernel: no FMA on a zero-filled column, one wave
        assert cfg["src"] == "fma" and cfg["bn"] == R1 * C
        per_sm = cfg["blocks_per_sm"]
        assert 132 * per_sm // 2 < cfg["grid"] <= 132 * per_sm
    elif (B, R1, R2, C) in SERVING_SHAPES + SHARD_SHAPES:
        # one tile of all N columns: w2 is read once; r2 split 4 ways, one
        # wave of 128 blocks; as the card packs clusters, float32 takes 2
        # clusters of 2 (a second sum), bf16 one cluster of 3
        assert cfg["by_n"] and cfg["nsplit"] == 4 and cfg["kparts"] == 1
        assert cfg["n_n"] == 1 and cfg["grid"] == 128
        on_card = _check_launch_config(B, R1, R2, C, 132, bf16,
                                       H100_CLUSTER_SLOTS)
        if bf16:
            assert (on_card["nsplit"], on_card["kparts"]) == (3, 1)
            assert on_card["grid"] == 96 and on_card["nparts"] == 1
        else:
            assert (on_card["nsplit"], on_card["kparts"]) == (2, 2)
            assert on_card["grid"] == 128 and on_card["nparts"] == 2
    if not bf16 and cfg["src"] != "fma":
        # "default" walks the same blocks and steps with one plane of pot
        one = _check_launch_config(B, R1, R2, C, 132, False,
                                   precision="default")
        assert {k: v for k, v in one.items()
                if k not in ("src", "planes", "stages", "smem_bytes")} == {
            k: v for k, v in cfg.items()
            if k not in ("src", "planes", "stages", "smem_bytes")}


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(
    B=st.integers(1, 100_000), R1=st.integers(1, 300),
    R2=st.integers(1, 70_000), C=st.integers(1, 400),
    n_sm=st.sampled_from([1, 16, 108, 132]),
    src=st.sampled_from(["bf16", "highest", "default"]),
    slots=st.sampled_from([None, H100_CLUSTER_SLOTS]),
)
def test_launch_config_sweep(B, R1, R2, C, n_sm, src, slots):
    _check_launch_config(B, R1, R2, C, n_sm, src == "bf16", slots,
                         "highest" if src == "bf16" else src)


def _fold_partial(T, w1_cols, C, n0):
    """One stage of the kernel's "fold" (C in {1, 2, 4, 8}): per row,
    w1 * T over the tile's columns, added by c = (n0 + col) mod C."""
    nrows, ncol = T.shape
    part = torch.zeros(nrows, C)
    for c in range(C):
        cols = [j for j in range(ncol) if (n0 + j) % C == c]
        part[:, c] = (w1_cols[:, cols] * T[:, cols]).sum(dim=1)
    return part


def _exponent(m):
    """e with 2^e <= m < 2^(e + 1), 0 where m is 0 (the kernel's
    exponent_of)."""
    e = torch.frexp(m)[1] - 1
    return torch.where(m == 0, torch.zeros_like(e), e)


def _pow2(e):
    """2^e exactly as float32, subnormals included."""
    return torch.exp2(e.double()).float()


def _scaled(x, k):
    """x * 2^k exactly in two factors (2^k alone may not be a float32)."""
    h = torch.div(k, 2, rounding_mode="trunc")
    return x * _pow2(h) * _pow2(k - h)


def _split3(x):
    """hi + mid + lo: three bf16 numbers (as float32) of a float32 tensor."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    return hi, mid, (x - hi - mid).to(torch.bfloat16).float()


# the six passes of "highest" as (w2 part, pot plane), small ones first
PASSES = ((1, 1), (0, 2), (2, 0), (1, 0), (0, 1), (0, 0))


def emulate_kernel(pot, w1, w2, n_sm=132, bf16=False, slots=None,
                   precision="highest"):
    """The CUDA kernel's tiling and arithmetic in plain float32 torch: the
    same blocks, r2 stages and epilogues, and the same fixed order of the
    partial sums (each stage's products summed, then added outside the
    tensor cores; w1 folded into each stage for C in {1, 2, 4, 8}, but for
    six passes at 128 columns with C = 1; the blocks of a cluster in rank
    order; several parts and column tiles by a second pass).  bf16 rounds
    pot and w2 first, as the wrapper does.  float32: each stage scales each
    row of its w2 tile, and each 64-column box of its pot tile, by the
    exponent of its largest element, splits both into bf16 parts (hi, mid,
    lo; hi alone for "default"), runs the six passes (one), and undoes both
    scales on the stage's sums; narrow products (N <= 32) take the
    CUDA-core kernel's f32 steps of 16 and contiguous r2 ranges.  It shows
    the index arithmetic and the split right where no card is.  A 3-D
    ``w2`` [B, R2g, rep] is read as the float32 tensor-core kernel reads
    the route's broadcast view: each stage's row is one group weight,
    ``w2[b, k0 // rep]``."""
    R1, R2, C = pot.shape
    B = w1.shape[0]
    cfg = fc.launch_config(B, R1, R2, C, n_sm, bf16,
                           None if slots is None else lambda bn, by_n: slots,
                           precision)
    f32, six = cfg["src"] in ("f32x6", "f32x1"), cfg["src"] == "f32x6"
    fma = cfg["src"] == "fma"  # the narrow kernel: f32 FMAs, no split
    if bf16:
        pot, w2 = (x.to(torch.bfloat16).float() for x in (pot, w2))
    BM, BN, bk = cfg["bm"], cfg["bn"], cfg["bk"]
    N = R1 * C
    ncols = N if cfg["by_n"] else C
    passes = PASSES if six else ((0, 0),)
    # partial [B, C] of each (column tile, split) block before any sum
    parts = {}
    for bt, nt, split in _blocks(cfg):
        b0, n0 = bt * BM, nt * BN
        rows = slice(b0, min(B, b0 + BM))
        nrows = rows.stop - rows.start
        n1 = min(n0 + BN, ncols)

        def stages(r1=None):
            """Each r2 step's products [BM, BN] (zero-filled at the edges),
            and the rows' scales to undo on them."""
            for step in _r2_steps(cfg, split, R2):
                k0 = step * bk
                k1 = min(k0 + bk, R2)
                a = torch.zeros(BM, bk)
                if w2.dim() == 3:  # the broadcast read: one value a row
                    a[:nrows] = w2[rows, k0 // w2.shape[2], :1]
                else:
                    a[:nrows, :k1 - k0] = w2[rows, k0:k1]
                by_rows = (pot.permute(1, 0, 2).reshape(R2, N) if r1 is None
                           else pot[r1])
                b = torch.zeros(bk, BN)
                b[:k1 - k0, :n1 - n0] = by_rows[k0:k1, n0:n1]
                if not f32:
                    yield a @ b, torch.ones(BM, BN)
                    continue
                e = _exponent(a.abs().amax(dim=1))
                a_parts = _split3(_scaled(a, -e[:, None]))
                # each 64-column box of pot by its own exponent
                b_exp = torch.stack([_exponent(b[:, j:j + 64].abs().max())
                                     for j in range(0, BN, 64)])
                b_exp = b_exp.repeat_interleave(64)
                b_parts = _split3(_scaled(b, -b_exp[None, :]))
                t = torch.zeros(BM, BN)
                for pa, pb in passes:
                    t += a_parts[pa] @ b_parts[pb]
                yield t, _pow2(e)[:, None] * _pow2(b_exp)[None, :]

        part = torch.full((nrows, C), float("nan"))
        if cfg["by_n"]:
            w1_cols = w1[rows][:, torch.arange(n0, n1) // C]
            # w1 folded into every stage (not by the narrow kernel, nor in
            # six passes at 128 columns with C = 1: registers)
            if 8 % C == 0 and not fma and not (six and BN == 128 and C == 1):
                part = torch.zeros(nrows, C)
                for t, u in stages():
                    part += _fold_partial((t * u)[:nrows, :n1 - n0], w1_cols,
                                          C, n0)
            else:  # the stages' sum, then columns of equal c, ascending n
                acc = torch.zeros(BM, BN)
                for t, u in stages():
                    acc += t * u
                part = torch.zeros(nrows, C)
                for j in range(n1 - n0):
                    part[:, (n0 + j) % C] += w1_cols[:, j] * acc[:nrows, j]
        else:
            tot = torch.zeros(BM, BN)
            for r1 in range(R1):
                acc = torch.zeros(BM, BN)
                for t, u in stages(r1):
                    acc += t * u
                tot[:nrows] += w1[rows, r1, None] * acc[:nrows]
            part[:, n0:n1] = tot[:nrows, :n1 - n0]
        parts[bt, nt, split] = (rows, part)
    # the blocks of a cluster (one tile and part, its nsplit splits) added
    # in rank order; one partial per part and column
    # tile of the "n" tiling, per part of the "c" tiling; then the partials
    # in a fixed order
    tiles = {}
    for (bt, nt, split), (rows, part) in sorted(
            parts.items(), key=lambda kv: kv[0][2]):
        # the narrow kernel: one partial per split, no cluster
        key = (bt, nt, split if fma else split // cfg["nsplit"])
        prev = tiles.get(key)
        tiles[key] = (rows, part if prev is None else prev[1] + part)
    ws = torch.full((cfg["nparts"], B, C), float("nan"))
    for (bt, nt, kp), (rows, part) in tiles.items():
        z = kp * cfg["n_n"] + nt if cfg["by_n"] and not fma else kp
        cols = (slice(0, C) if cfg["by_n"]
                else slice(nt * BN, min(C, (nt + 1) * BN)))
        assert torch.isnan(ws[z, rows, cols]).all()  # written once
        ws[z, rows, cols] = part[:, cols]
    assert not torch.isnan(ws).any()  # every partial was written
    out = torch.zeros(B, C)
    for z in range(cfg["nparts"]):
        out += ws[z]
    assert not torch.isnan(out).any()  # every output was written
    return out, cfg


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "R1,R2,C,B",
    [(4, 8, 3, 5), (1, 37, 1, 5), (3, 50, 17, 33), (8, 128, 2, 300),
     (40, 70, 2, 130), (70, 40, 2, 130), (5, 70, 300, 130), (2, 40, 70, 129),
     (3, 1, 2, 1),
     # model-shard-like (N = 4, 16, 16), C = 4 and 8
     (4, 64, 1, 130), (8, 96, 2, 300), (16, 128, 1, 70), (6, 90, 4, 140),
     (9, 200, 8, 150),
     # the "c" tiling of a gradient: C = 300 columns in 5 tiles, R1 = 2
     (2, 64, 300, 130)],
)
def test_kernel_emulation_matches_plain_and_jax_kernel(R1, R2, C, B, bf16):
    """The emulation against the plain version and the JAX kernel in
    interpret mode at "highest", within 2e-6 of max|out|; a row of exact
    zeros stays exactly 0, and a row whose w2 is all 1e-38 (subnormal in
    f32 and bf16) within rtol 1e-3 of the plain version."""
    rng = np.random.default_rng(R1 + R2 + C + B + 2)
    pot = rng.random((R1, R2, C)).astype(np.float32)
    w1 = rng.random((B, R1)).astype(np.float32)
    w2 = rng.random((B, R2)).astype(np.float32)
    w2[0] = 0.0  # an impossible row stays exactly zero
    if B > 1:
        w2[1] = 1e-38  # the serving floor
    if bf16:  # the kernel's inputs: pot and w2 rounded to bf16
        pot, w2 = (_t(x).to(torch.bfloat16).float().numpy() for x in (pot, w2))
    got, cfg = emulate_kernel(_t(pot), _t(w1), _t(w2), bf16=bf16)
    assert cfg["by_n"] == (C <= 32)
    want = fc.reference_factored_contract(_t(pot), _t(w1), _t(w2))
    kern = jax_pc.factored_masked_contract(
        jnp.asarray(pot), jnp.asarray(w1), jnp.asarray(w2), interpret=True,
        precision="highest",
    )
    tol = 2e-6 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert float(np.abs(got.numpy() - np.asarray(kern)).max()) <= tol
    assert (got[0] == 0).all()
    if B > 1:
        assert (want[1] > 0).all()
        torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=0)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_kernel_emulation_when_a_wave_walks_the_tiles(bf16):
    """The "c" tiling with more tiles than SMs and no cluster: a wave of
    n_sm blocks takes the tiles in turn (here 4 blocks for 15 tiles)."""
    rng = np.random.default_rng(9)
    R1, R2, C, B = 2, 40, 300, 300
    pot, w1, w2 = (_t(rng.random(s).astype(np.float32))
                   for s in ((R1, R2, C), (B, R1), (B, R2)))
    got, cfg = emulate_kernel(pot, w1, w2, n_sm=4, bf16=bf16)
    assert not cfg["by_n"] and cfg["n_b"] * cfg["n_n"] == 15
    assert cfg["grid"] == 4 and cfg["nsplit"] == cfg["kparts"] == 1
    if bf16:
        pot, w2 = pot.to(torch.bfloat16), w2.to(torch.bfloat16)
    want = fc.reference_factored_contract(pot, w1, w2)
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


def _broadcast_case(R1, R2g, rep, C, B, seed):
    """pot [R1, R2g * rep, C], w1 and the route's broadcast view of the
    group weights g [B, R2g] over ``rep`` (a stride-0 view), with a row of
    zeros, a row at the serving floor 1e-38 and a row whose groups mix
    zeros and the floor with ordinary values."""
    rng = np.random.default_rng(seed)
    pot = _t(rng.random((R1, R2g * rep, C)).astype(np.float32))
    w1 = _t(rng.random((B, R1)).astype(np.float32))
    g = _t(rng.random((B, R2g)).astype(np.float32))
    g[0] = 0.0
    g[1] = 1e-38
    g[2, ::2] = 0.0
    g[2, 1::4] = 1e-38
    return pot, w1, g[:, :, None].expand(B, R2g, rep)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize(
    "R1,R2g,rep,C,B,slots",
    [(20, 4, 32, 2, 300, None), (40, 1, 64, 1, 130, None),
     (10, 2, 128, 4, 129, None), (40, 1, 256, 2, 130, None),
     # the "c" tiling, and r2 split over clusters at B = 4096 on an H100
     (2, 2, 32, 70, 130, None), (40, 3, 64, 2, 4096, H100_CLUSTER_SLOTS)],
)
def test_kernel_emulation_reads_the_broadcast_view_bit_for_bit(
        R1, R2g, rep, C, B, slots, precision):
    """The float32 kernel's broadcast read of ``w2`` (each stage's row one
    group weight, fetched by the stage's r2 step) gives the same bits as
    its read of the expanded operand, at both precisions, with rows of
    zeros and at 1e-38; and within 2e-6 of max|out| of the plain version
    at "highest"."""
    pot, w1, view = _broadcast_case(R1, R2g, rep, C, B, R1 + R2g + rep + C)
    flat = view.reshape(B, -1)
    got, cfg = emulate_kernel(pot, w1, view, slots=slots, precision=precision)
    assert cfg["src"] == {"highest": "f32x6", "default": "f32x1"}[precision]
    assert rep % cfg["bk"] == 0
    want, _ = emulate_kernel(pot, w1, flat, slots=slots, precision=precision)
    assert torch.equal(got, want)
    assert (got[0] == 0).all() and (got[1] > 0).all()
    if precision == "highest":
        plain = fc.reference_factored_contract(pot, w1, flat)
        assert float((got - plain).abs().max()) <= \
            2e-6 * float(plain.abs().max())


@pytest.mark.parametrize("rep", [32, 64, 3])
@pytest.mark.parametrize("fn", ["wrapper", "plain"])
def test_wrapper_and_plain_take_the_broadcast_view(fn, rep):
    """``factored_masked_contract`` and the plain version take the route's
    3-D view [B, R2g, rep] and give what the expanded [B, R2] operand
    gives, bit for bit; on the CPU the view is expanded and counted in
    ``route.materialized_bytes`` (B * R2 * 4 bytes), and no launch reads
    it by broadcast."""
    pot, w1, view = _broadcast_case(5, 3, rep, 2, 33, rep)
    flat = view.reshape(33, -1).clone()
    call = {"wrapper": fc.factored_masked_contract,
            "plain": fc.reference_factored_contract}[fn]
    before = TIMERS.counters()
    got = call(pot, w1, view)
    mid = TIMERS.counters()
    want = call(pot, w1, flat)
    after = TIMERS.counters()
    assert torch.equal(got, want)
    key = "route.materialized_bytes"
    assert mid[key] - before[key] == flat.numel() * 4
    assert after[key] == mid[key]  # a 2-D operand is used as it is
    assert after["factored_masked_contract.broadcast"] == \
        before["factored_masked_contract.broadcast"]


def test_route_hands_kernel_or_plain_the_broadcast_view(monkeypatch):
    """The route hands ``kernel_or_plain(pot, w1, w2)`` (its signature
    unchanged) ``w2`` as the view of the group weights over the rest
    variables without evidence: 3-D, stride 0 on its last axis, B * R2
    elements; with ``contract_fn`` the expanded [B, R2] operand."""
    import inspect

    assert list(inspect.signature(fc.kernel_or_plain).parameters) == \
        ["pot", "w1", "w2"]
    seen = []
    orig = fc.kernel_or_plain

    def record(pot, w1, w2):
        seen.append((tuple(pot.shape), w2))
        return orig(pot, w1, w2)

    monkeypatch.setattr(fc, "kernel_or_plain", record)
    rng = np.random.default_rng(3)
    shape = (2, 3, 2, 2, 4, 2)  # variables 0..5; 2 and 4 carry no evidence
    pot = _t(rng.random(shape))
    masks = {v: _t(rng.random((6, shape[v]))) for v in (0, 1, 3)}
    got = fc.big_clique_sep_message(pot, list(range(6)), masks, [5])
    (R1, R2, C), w2 = seen[0]
    assert w2.dim() == 3 and w2.stride(2) == 0 and w2.shape[2] == 2 * 4
    assert w2.numel() == 6 * R2 and R1 * R2 * C == pot.numel()
    shards = []
    want = fc.big_clique_sep_message(
        pot, list(range(6)), masks, [5],
        contract_fn=lambda p, a, b: shards.append(b) or
        fc.reference_factored_contract(p, a, b))
    assert shards[0].dim() == 2 and shards[0].numel() == w2.numel()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    dense = torch.einsum("abcdef,za,zb,zd->zf", pot.double(),
                         *(masks[v].double() for v in (0, 1, 3)))
    torch.testing.assert_close(got.double(), dense, rtol=1e-5, atol=0)


@pytest.mark.parametrize("R1,R2,C,B", [(40, 128, 2, 300), (5, 70, 300, 130),
                                       (3, 50, 17, 33)])
def test_kernel_emulation_at_default_precision(R1, R2, C, B):
    """"default": one bf16 pass of the scaled operands, f32 sums; within
    2e-2 of max|out| (bf16's own rounding, twice), as the JAX kernel's
    "default" is on the TPU (on the CPU it computes exactly).  Narrow
    products (N <= 32) stay exact on the CUDA cores at either precision."""
    rng = np.random.default_rng(R1 + R2 + C + B + 3)
    pot, w1, w2 = (rng.random(s).astype(np.float32)
                   for s in ((R1, R2, C), (B, R1), (B, R2)))
    got, cfg = emulate_kernel(_t(pot), _t(w1), _t(w2), precision="default")
    assert cfg["src"] == "f32x1"
    want = fc.reference_factored_contract(_t(pot), _t(w1), _t(w2))
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert 1e-6 < err <= 2e-2  # one pass: visibly not f32-accurate
    narrow, cfg = emulate_kernel(_t(pot[:4, :, :2]), _t(w1[:, :4]), _t(w2),
                                 precision="default")
    assert cfg["src"] == "fma"
    want = fc.reference_factored_contract(_t(pot[:4, :, :2]), _t(w1[:, :4]),
                                          _t(w2))
    assert float((narrow - want).abs().max()) <= 2e-6 * float(want.abs().max())


def test_bf16_emulation_on_the_cards_cluster_packing():
    """With the clusters an H100 holds at B = 4096 (bf16: one cluster of 3
    blocks along r2; f32: 2 clusters of 2), the tiling still covers every
    r2 step once."""
    rng = np.random.default_rng(5)
    R1, R2, C, B = 40, 300, 2, 4096
    pot, w1, w2 = (_t(rng.random(s).astype(np.float32))
                   for s in ((R1, R2, C), (B, R1), (B, R2)))
    for bf16 in (True, False):
        got, cfg = emulate_kernel(pot, w1, w2, bf16=bf16,
                                  slots=H100_CLUSTER_SLOTS)
        assert (cfg["nsplit"], cfg["kparts"]) == ((3, 1) if bf16 else (2, 2))
        if bf16:
            want = fc.reference_factored_contract(
                pot.to(torch.bfloat16), w1, w2.to(torch.bfloat16))
        else:
            want = fc.reference_factored_contract(pot, w1, w2)
        assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


@pytest.mark.parametrize("by_n", [True, False], ids=["n", "c"])
@pytest.mark.parametrize("scale", [1.0, 1e-37, 3e30])
def test_reference_split_reconstructs_pot(by_n, scale):
    """The plain version of the kernel's pot split: each box of bk rows and
    64 columns scaled by its own exponent into [1, 2), hi + mid + lo equal
    to the scaled f32 values within f32's rounding (and exactly for hi
    alone at one plane, to bf16's), padding columns and zero boxes zero;
    tiny (subnormal-range) and huge potentials alike."""
    rng = np.random.default_rng(7)
    R1, R2, C = (5, 70, 3) if by_n else (3, 70, 40)
    pot = _t(rng.random((R1, R2, C)).astype(np.float32) * scale)
    pot[0, :40] = 0.0  # zero rows: some boxes all zero
    planes, exps = fc.reference_split_pot(pot, by_n, 32)
    rows, ncols = (R2, R1 * C) if by_n else (R1 * R2, C)
    ld = -(-ncols // 8) * 8
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, rows, ld)
    n_k, ncb = -(-R2 // 32), -(-ncols // 64)
    assert exps.shape == ((1 if by_n else R1) * n_k * ncb,)
    x = (pot.permute(1, 0, 2).reshape(R2, -1) if by_n
         else pot.reshape(R1 * R2, C)).double()
    grp = torch.zeros(rows, dtype=torch.long) if by_n else \
        torch.arange(rows) // R2
    box = (grp * n_k + (torch.arange(rows) % R2) // 32) * ncb
    scale_of_row = torch.exp2(exps[box].double())
    rec = planes.double().sum(0)
    assert not rec[:, ncols:].any()
    got = rec[:, :ncols] * scale_of_row[:, None]
    err = (got - x).abs() / (x.abs().max() + 1e-300)
    assert float(err.max()) <= 2.0 ** -23
    m = planes[0].float().abs()
    assert float(m.max()) <= 2.0  # each box's largest: [1, 2), hi rounded
    hi, _ = fc.reference_split_pot(pot, by_n, 32, planes=1)
    assert torch.equal(hi[0], planes[0])


@pytest.mark.parametrize(
    "shape,offset,copied,dtype",
    [((5, 64), 0, False, torch.bfloat16), ((5, 37), 0, True, torch.bfloat16),
     ((5, 64), 1, True, torch.bfloat16), ((3, 8), 8, False, torch.bfloat16),
     ((5, 32), 0, False, torch.float32), ((5, 36), 0, False, torch.float32),
     ((5, 37), 0, True, torch.float32), ((5, 64), 1, True, torch.float32),
     ((3, 8), 4, False, torch.float32)],
)
def test_tma_rows_copies_only_what_tma_cannot_take(shape, offset, copied,
                                                   dtype):
    """w2 (bf16 or f32) and bf16 pot go to the Tensor Memory Accelerator as
    they are when their address is 16-byte aligned and their rows a
    multiple of 16 bytes; others are copied into a zero-padded, aligned
    buffer, and the copy is counted."""
    rows, n = shape
    per = 16 // torch.tensor([], dtype=dtype).element_size()
    buf = torch.arange(rows * n + offset, dtype=torch.float32).to(dtype)
    t = buf[offset:].view(rows, n)
    assert (t.data_ptr() % 16 == 0) == (offset % per == 0)
    before = TIMERS.counters()["factored_masked_contract.padded"]
    got, ld = fc._tma_rows(t)
    assert TIMERS.counters()["factored_masked_contract.padded"] - before \
        == int(copied)
    assert (got.data_ptr() == t.data_ptr()) == (not copied)
    assert ld % per == 0 and got.data_ptr() % 16 == 0 and ld >= n
    assert torch.equal(got[:, :n], t) and not got[:, n:].any()


def test_sep_message_hands_the_kernel_its_layout(monkeypatch):
    """big_clique_sep_message's one copy of the permuted potential is already
    in the layout the kernel reads, so the wrapper need not copy again."""
    seen = []
    monkeypatch.setattr(
        fc, "factored_masked_contract",
        lambda pot, w1, w2: seen.append(pot) or
        fc.reference_factored_contract(pot, w1, w2),
    )
    for name in ("masks", "messages"):
        pot, cvars, masks, svars, msgs = _sep_message_case(name)
        fc.big_clique_sep_message(
            _t(pot), cvars, {v: _t(m) for v, m in masks.items()}, svars,
            msgs=[(vs, _t(m)) for vs, m in msgs],
        )
    rng = np.random.default_rng(2)  # a separator wider than 32 states
    fc.big_clique_sep_message(
        _t(rng.random((2, 3, 40))), [0, 1, 2], {0: _t(rng.random((4, 2)))}, [2]
    )
    assert [fc.tiles_by_n(p.shape[2]) for p in seen] == [True, True, False]
    for p in seen:
        rows = p.permute(1, 0, 2) if fc.tiles_by_n(p.shape[2]) else p
        assert rows.is_contiguous()


def test_cpu_wrapper_launches_nothing():
    pot, w1, w2 = torch.ones(2, 3, 1), torch.ones(4, 2), torch.ones(4, 3)
    before = TIMERS.counters()["factored_masked_contract.launches"]
    out = fc.factored_masked_contract(pot, w1, w2)
    assert TIMERS.counters()["factored_masked_contract.launches"] == before
    assert torch.equal(out, torch.full((4, 1), 6.0))
