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
               (4097, 64, 4095, 1), (70000, 2, 40, 3)]
# clusters of 1..8 bf16 blocks that an H100 SXM holds at once, as
# cudaOccupancyMaxActiveClusters reported them on the card
H100_CLUSTER_SLOTS = (132, 66, 39, 30, 22, 17, 15, 15)


def _blocks(cfg):
    """(row tile, column tile, split) of every block, decoded as the kernel
    decodes blockIdx.x."""
    for bid in range(cfg["grid"]):
        if cfg["bf16"]:  # (column tile * n_b + row tile) * nsplit + split
            tile, split = divmod(bid, cfg["nsplit"])
            nt, bt = divmod(tile, cfg["n_b"])
        else:            # (split * n_n + column tile) * n_b + row tile
            rest, bt = divmod(bid, cfg["n_b"])
            split, nt = divmod(rest, cfg["n_n"])
        yield bt, nt, split


def _r2_steps(cfg, split, R2):
    """The r2 steps of ``bk`` that block ``split`` walks."""
    n_k = -(-R2 // cfg["bk"])
    if cfg["bf16"]:  # split, split + nsplit, ...
        return range(split, n_k, cfg["nsplit"])
    per = cfg["k_per_split"] // cfg["bk"]
    return range(split * per, min(n_k, (split + 1) * per))


def _check_launch_config(B, R1, R2, C, n_sm, bf16, slots=None):
    """The blocks, decoded as the kernel decodes them, cover every row,
    column and r2 step exactly once, within CUDA's limits and the block's
    227 KB of shared memory."""
    cfg = fc.launch_config(B, R1, R2, C, n_sm, bf16,
                           None if slots is None else lambda bn, by_n: slots)
    by_n = cfg["by_n"]
    assert by_n == fc.tiles_by_n(C) == (C <= 32) and cfg["bf16"] == bf16
    ncols = R1 * C if by_n else C
    n_k = -(-R2 // cfg["bk"])
    if bf16:
        # all of N <= 128 in one tile: w2 is read once
        assert (cfg["bm"], cfg["bk"]) == (128, 64)
        assert cfg["bn"] == (128 if by_n and ncols > 64 else 64)
        assert cfg["k_per_split"] == 64
        assert 1 <= cfg["nsplit"] <= min(8, n_k)
        assert cfg["nparts"] == (cfg["n_n"] if by_n and cfg["n_n"] > 1 else 1)
        assert cfg["blocks_per_sm"] == 1
        # the largest cluster whose tiles' clusters are all resident at once
        have = slots or [n_sm // size for size in range(1, 9)]
        tiles = cfg["n_b"] * cfg["n_n"]
        fits = [size for size in range(1, min(8, n_k) + 1)
                if have[size - 1] >= tiles]
        assert cfg["nsplit"] == max(fits, default=1)
        assert cfg["smem_bytes"] == fc.bf16_smem_bytes(cfg["bn"])
    else:
        # the narrowest column tile that holds N, and 8192 accumulators
        want_bn = next((w for w in (16, 32) if by_n and ncols <= w), 64)
        assert cfg["bn"] == want_bn and cfg["bm"] * cfg["bn"] == 8192
        assert cfg["bk"] == 16 and cfg["k_per_split"] % 16 == 0
        assert cfg["nparts"] == cfg["nsplit"] * (cfg["n_n"] if by_n else 1)
        assert cfg["smem_bytes"] == fc.f32_smem_bytes(cfg["bn"])
        assert cfg["blocks_per_sm"] == min(
            2, fc.SMEM_PER_SM // (cfg["smem_bytes"] + 1024))
        if cfg["nsplit"] > 1:  # r2 is split only to fill one wave
            assert cfg["grid"] <= cfg["blocks_per_sm"] * n_sm
    assert cfg["smem_bytes"] <= fc.MAX_SMEM_PER_BLOCK == 232_448
    for n_tiles, tile, extent in ((cfg["n_b"], cfg["bm"], B),
                                  (cfg["n_n"], cfg["bn"], ncols)):
        # ranges [i * tile, min((i + 1) * tile, extent)) are non-empty,
        # disjoint, and end at extent: every index lies in exactly one
        assert (n_tiles - 1) * tile < extent <= n_tiles * tile
    assert cfg["grid"] == cfg["n_b"] * cfg["n_n"] * cfg["nsplit"]
    assert 1 <= cfg["grid"] <= fc.MAX_GRID_X
    # every split walks at least one step, and the splits of a tile walk
    # every step exactly once
    steps = [s for z in range(cfg["nsplit"]) for s in _r2_steps(cfg, z, R2)]
    assert all(len(_r2_steps(cfg, z, R2)) > 0 for z in range(cfg["nsplit"]))
    assert sorted(steps) == list(range(n_k))
    if cfg["grid"] <= 1 << 16:
        seen = set(_blocks(cfg))
        assert len(seen) == cfg["grid"]
        assert seen == {(bt, nt, z) for bt in range(cfg["n_b"])
                        for nt in range(cfg["n_n"])
                        for z in range(cfg["nsplit"])}
    return cfg


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,R1,R2,C", SERVING_SHAPES + SHARD_SHAPES + EDGE_SHAPES)
def test_launch_config_covers_every_output_and_r2(B, R1, R2, C, bf16):
    cfg = _check_launch_config(B, R1, R2, C, 132, bf16)
    if (B, R1, R2, C) in SERVING_SHAPES + SHARD_SHAPES:
        assert cfg["by_n"] and cfg["nsplit"] > 1
        if bf16:
            # one tile of all N columns: w2 is read once; one wave of
            # clusters along r2, as the card packs them
            assert cfg["n_n"] == 1 and cfg["grid"] <= 132
            on_card = _check_launch_config(B, R1, R2, C, 132, True,
                                           H100_CLUSTER_SLOTS)
            assert on_card["nsplit"] == 3 and on_card["grid"] == 96
        else:
            # r2 is split until the card is full: one wave of blocks
            per_sm = cfg["blocks_per_sm"]
            assert 132 * per_sm // 2 < cfg["grid"] <= 132 * per_sm
    if (B, R1, R2, C) in SHARD_SHAPES and not bf16:
        # the narrow tiling: no FMA on a zero-filled column
        assert cfg["bn"] == R1 * C and cfg["n_n"] == 1


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(
    B=st.integers(1, 100_000), R1=st.integers(1, 300),
    R2=st.integers(1, 70_000), C=st.integers(1, 400),
    n_sm=st.sampled_from([1, 16, 108, 132]), bf16=st.booleans(),
    slots=st.sampled_from([None, H100_CLUSTER_SLOTS]),
)
def test_launch_config_sweep(B, R1, R2, C, n_sm, bf16, slots):
    _check_launch_config(B, R1, R2, C, n_sm, bf16, slots)


def _fold_partial(T, w1_cols, C, n0):
    """One stage of the bf16 kernel's "fold" (C in {1, 2, 4, 8}): per row,
    w1 * T over the tile's columns, added by c = (n0 + col) mod C."""
    nrows, ncol = T.shape
    part = torch.zeros(nrows, C)
    for c in range(C):
        cols = [j for j in range(ncol) if (n0 + j) % C == c]
        part[:, c] = (w1_cols[:, cols] * T[:, cols]).sum(dim=1)
    return part


def emulate_kernel(pot, w1, w2, n_sm=132, bf16=False, slots=None):
    """The CUDA kernel's tiling in plain float32 torch: the same blocks, the
    same r2 steps and epilogues, and the same fixed order of the partial
    sums (the float32 kernel's in a second pass; the bf16 kernel's stages
    added outside the tensor cores, w1 folded into each stage for C in
    {1, 2, 4, 8}, then its cluster's blocks in rank order).  bf16 rounds pot
    and w2 first, as the wrapper does.  It shows the index arithmetic right
    where no card is."""
    R1, R2, C = pot.shape
    B = w1.shape[0]
    if bf16:
        pot, w2 = (x.to(torch.bfloat16).float() for x in (pot, w2))
    cfg = fc.launch_config(B, R1, R2, C, n_sm, bf16,
                           None if slots is None else lambda bn, by_n: slots)
    BM, BN, bk = cfg["bm"], cfg["bn"], cfg["bk"]
    N = R1 * C
    ncols = N if cfg["by_n"] else C
    by_rows = pot.permute(1, 0, 2).reshape(R2, N)  # the "n" tiling's layout
    nsplit = cfg["nsplit"]
    # partial [B, C] of each (column tile, split) block before any sum
    parts = {}
    for bt, nt, split in _blocks(cfg):
        b0, n0 = bt * BM, nt * BN
        rows = slice(b0, min(B, b0 + BM))
        nrows = rows.stop - rows.start
        n1 = min(n0 + BN, ncols)

        def stages(bmat):
            """Each r2 step's product [BM, BN], zero-filled at the edges."""
            for step in _r2_steps(cfg, split, R2):
                k0 = step * bk
                k1 = min(k0 + bk, R2)
                a, b = torch.zeros(BM, bk), torch.zeros(bk, BN)
                a[:nrows, :k1 - k0] = w2[rows, k0:k1]
                b[:k1 - k0, :n1 - n0] = bmat[k0:k1, n0:n1]
                yield a @ b

        part = torch.full((nrows, C), float("nan"))
        if cfg["by_n"]:
            w1_cols = w1[rows][:, torch.arange(n0, n1) // C]
            if bf16 and 8 % C == 0:  # w1 folded into every stage
                part = torch.zeros(nrows, C)
                for t in stages(by_rows):
                    part += _fold_partial(t[:nrows, :n1 - n0], w1_cols, C, n0)
            else:  # the stages' sum, then columns of equal c, ascending n
                acc = torch.zeros(BM, BN)
                for t in stages(by_rows):
                    acc += t
                part = torch.zeros(nrows, C)
                for j in range(n1 - n0):
                    part[:, (n0 + j) % C] += w1_cols[:, j] * acc[:nrows, j]
        else:
            tot = torch.zeros(BM, BN)
            for r1 in range(R1):
                acc = torch.zeros(BM, BN)
                for t in stages(pot[r1]):
                    acc += t
                tot[:nrows] += w1[rows, r1, None] * acc[:nrows]
            part[:, n0:n1] = tot[:nrows, :n1 - n0]
        parts[bt, nt, split] = (rows, part)
    # bf16: the blocks of a cluster (one tile, all splits) added in rank
    # order, one partial per column tile of the "n" tiling; f32: one
    # partial per (split, column tile) of the "n" tiling, per split of the
    # "c" tiling.  Then the partials in a fixed order.
    if bf16:
        tiles = {}
        for (bt, nt, split), (rows, part) in sorted(
                parts.items(), key=lambda kv: kv[0][2]):
            prev = tiles.get((bt, nt))
            tiles[bt, nt] = (rows, part if prev is None else prev[1] + part)
        placed = {(bt, nt, nt if cfg["by_n"] else 0): v
                  for (bt, nt), v in tiles.items()}
    else:
        placed = {(bt, nt, split * cfg["n_n"] + nt if cfg["by_n"] else split): v
                  for (bt, nt, split), v in parts.items()}
    ws = torch.full((cfg["nparts"], B, C), float("nan"))
    for (bt, nt, z), (rows, part) in placed.items():
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
     # model-shard-like: the narrow f32 tiles (N = 4, 16, 16), C = 4 and 8
     (4, 64, 1, 130), (8, 96, 2, 300), (16, 128, 1, 70), (6, 90, 4, 140),
     (9, 200, 8, 150)],
)
def test_kernel_emulation_matches_plain_and_jax_kernel(R1, R2, C, B, bf16):
    rng = np.random.default_rng(R1 + R2 + C + B + 2)
    pot = rng.random((R1, R2, C)).astype(np.float32)
    w1 = rng.random((B, R1)).astype(np.float32)
    w2 = rng.random((B, R2)).astype(np.float32)
    w2[0] = 0.0  # an impossible row stays exactly zero
    if bf16:  # the kernel's inputs: pot and w2 rounded to bf16
        pot, w2 = (_t(x).to(torch.bfloat16).float().numpy() for x in (pot, w2))
    got, cfg = emulate_kernel(_t(pot), _t(w1), _t(w2), bf16=bf16)
    assert cfg["by_n"] == (C <= 32)
    want = fc.reference_factored_contract(_t(pot), _t(w1), _t(w2))
    kern = jax_pc.factored_masked_contract(
        jnp.asarray(pot), jnp.asarray(w1), jnp.asarray(w2), interpret=True
    )
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert float(np.abs(got.numpy() - np.asarray(kern)).max()) <= tol
    assert (got[0] == 0).all()


def test_bf16_emulation_on_the_cards_cluster_packing():
    """With the clusters an H100 holds (3 blocks along r2 at B = 4096), the
    bf16 tiling still covers every r2 step once."""
    rng = np.random.default_rng(5)
    R1, R2, C, B = 4, 700, 2, 4096
    pot, w1, w2 = (_t(rng.random(s).astype(np.float32))
                   for s in ((R1, R2, C), (B, R1), (B, R2)))
    got, cfg = emulate_kernel(pot, w1, w2, bf16=True,
                              slots=H100_CLUSTER_SLOTS)
    assert cfg["nsplit"] == 3
    want = fc.reference_factored_contract(
        pot.to(torch.bfloat16), w1, w2.to(torch.bfloat16))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize(
    "shape,offset,copied",
    [((5, 64), 0, False), ((5, 37), 0, True), ((5, 64), 1, True),
     ((3, 8), 8, False)],
)
def test_tma_rows_copies_only_what_tma_cannot_take(shape, offset, copied):
    """bf16 operands go to the Tensor Memory Accelerator as they are when
    their address is 16-byte aligned and their rows a multiple of 8
    elements; others are copied into a zero-padded, aligned buffer, and
    the copy is counted."""
    rows, n = shape
    buf = torch.arange(rows * n + offset, dtype=torch.float32).to(torch.bfloat16)
    t = buf[offset:].view(rows, n)
    assert (t.data_ptr() % 16 == 0) == (offset % 8 == 0)
    before = fc.factored_masked_contract.padded
    got, ld = fc._tma_rows(t)
    assert fc.factored_masked_contract.padded - before == int(copied)
    assert (got.data_ptr() == t.data_ptr()) == (not copied)
    assert ld % 8 == 0 and got.data_ptr() % 16 == 0 and ld >= n
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
    before = fc.factored_masked_contract.launches
    out = fc.factored_masked_contract(pot, w1, w2)
    assert fc.factored_masked_contract.launches == before
    assert torch.equal(out, torch.full((4, 1), 6.0))
