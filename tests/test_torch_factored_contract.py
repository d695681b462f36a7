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
EDGE_SHAPES = [(5, 1, 37, 1), (33, 3, 50, 17), (130, 5, 70, 300),
               (4097, 64, 4095, 1), (70000, 2, 40, 3)]


def _check_launch_config(B, R1, R2, C, n_sm, bf16):
    """The blocks, decoded as the kernel decodes them, cover every row,
    column and r2 index exactly once, within CUDA's limits."""
    cfg = fc.launch_config(B, R1, R2, C, n_sm, bf16)
    assert cfg["by_n"] == fc.tiles_by_n(C) == (C <= 32)
    assert cfg["bk"] == (32 if bf16 else 16)
    ncols = R1 * C if cfg["by_n"] else C
    k = cfg["k_per_split"]
    assert k % cfg["bk"] == 0
    for n_tiles, tile, extent in ((cfg["n_b"], fc.BM, B),
                                  (cfg["n_n"], fc.BN, ncols),
                                  (cfg["nsplit"], k, R2)):
        # ranges [i * tile, min((i + 1) * tile, extent)) are non-empty,
        # disjoint, and end at extent: every index lies in exactly one
        assert (n_tiles - 1) * tile < extent <= n_tiles * tile
    assert cfg["grid"] == cfg["n_b"] * cfg["n_n"] * cfg["nsplit"]
    assert 1 <= cfg["grid"] <= fc.MAX_GRID_X
    assert cfg["nparts"] == cfg["nsplit"] * (cfg["n_n"] if cfg["by_n"] else 1)
    assert cfg["smem_bytes"] <= 48 * 1024 <= fc.MAX_SMEM_PER_BLOCK == 232_448
    if cfg["grid"] <= 1 << 16:
        seen = set()
        for bid in range(cfg["grid"]):
            rest, bt = divmod(bid, cfg["n_b"])
            split, nt = divmod(rest, cfg["n_n"])
            assert split < cfg["nsplit"]
            seen.add((bt, nt, split))
        assert len(seen) == cfg["grid"]
    return cfg


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,R1,R2,C", SERVING_SHAPES + EDGE_SHAPES)
def test_launch_config_covers_every_output_and_r2(B, R1, R2, C, bf16):
    cfg = _check_launch_config(B, R1, R2, C, 132, bf16)
    if (B, R1, R2, C) in SERVING_SHAPES:
        # r2 is split until the card is full: one wave of 2 blocks an SM
        assert 132 <= cfg["grid"] <= 132 * 2
        assert cfg["by_n"] and cfg["nsplit"] > 1


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(
    B=st.integers(1, 100_000), R1=st.integers(1, 300),
    R2=st.integers(1, 70_000), C=st.integers(1, 400),
    n_sm=st.sampled_from([1, 16, 108, 132]), bf16=st.booleans(),
)
def test_launch_config_sweep(B, R1, R2, C, n_sm, bf16):
    _check_launch_config(B, R1, R2, C, n_sm, bf16)


def emulate_kernel(pot, w1, w2, n_sm=132):
    """The CUDA kernel's tiling in plain float32 torch: the same blocks, the
    same r2 steps, the same epilogue order and the same fixed-order sum of
    the partials.  It shows the index arithmetic right where no card is."""
    R1, R2, C = pot.shape
    B = w1.shape[0]
    cfg = fc.launch_config(B, R1, R2, C, n_sm)
    BM, BN, bk, kps = fc.BM, fc.BN, cfg["bk"], cfg["k_per_split"]
    N = R1 * C
    ws = torch.full((cfg["nparts"], B, C), float("nan"))
    by_rows = pot.permute(1, 0, 2).reshape(R2, N)  # the "n" tiling's layout
    for bid in range(cfg["grid"]):
        rest, bt = divmod(bid, cfg["n_b"])
        split, nt = divmod(rest, cfg["n_n"])
        b0, n0, k_begin = bt * BM, nt * BN, split * kps
        k_end = min(R2, k_begin + kps)
        rows = slice(b0, min(B, b0 + BM))
        nrows = rows.stop - rows.start

        def main_loop(bmat, ncols):
            acc = torch.zeros(BM, BN)
            for k0 in range(k_begin, k_end, bk):
                k1, n1 = min(k0 + bk, k_end), min(n0 + BN, ncols)
                a, b = torch.zeros(BM, bk), torch.zeros(bk, BN)
                a[:nrows, :k1 - k0] = w2[rows, k0:k1]
                b[:k1 - k0, :n1 - n0] = bmat[k0:k1, n0:n1]
                acc += a @ b
            return acc

        if cfg["by_n"]:
            acc = main_loop(by_rows, N)
            n_hi = min(N, n0 + BN)
            for c in range(C):
                n = n0 + (c - n0 % C + C) % C
                r1 = n // C
                s = torch.zeros(nrows)
                while n < n_hi:
                    s = s + w1[rows, r1] * acc[:nrows, n - n0]
                    n, r1 = n + C, r1 + 1
                ws[rest, rows, c] = s
        else:
            tot = torch.zeros(BM, BN)
            for r1 in range(R1):
                acc = main_loop(pot[r1], C)
                tot[:nrows] += w1[rows, r1, None] * acc[:nrows]
            n1 = min(n0 + BN, C)
            ws[split, rows, n0:n1] = tot[:nrows, :n1 - n0]
    assert not torch.isnan(ws).any()  # every partial was written
    out = torch.zeros(B, C)
    for z in range(cfg["nparts"]):
        out += ws[z]
    return out, cfg


@pytest.mark.parametrize(
    "R1,R2,C,B",
    [(4, 8, 3, 5), (1, 37, 1, 5), (3, 50, 17, 33), (8, 128, 2, 300),
     (40, 70, 2, 130), (70, 40, 2, 130), (5, 70, 300, 130), (2, 40, 70, 129),
     (3, 1, 2, 1)],
)
def test_kernel_emulation_matches_plain_and_jax_kernel(R1, R2, C, B):
    rng = np.random.default_rng(R1 + R2 + C + B + 2)
    pot = rng.random((R1, R2, C)).astype(np.float32)
    w1 = rng.random((B, R1)).astype(np.float32)
    w2 = rng.random((B, R2)).astype(np.float32)
    w2[0] = 0.0  # an impossible row stays exactly zero
    got, cfg = emulate_kernel(_t(pot), _t(w1), _t(w2))
    assert cfg["by_n"] == (C <= 32)
    want = fc.reference_factored_contract(_t(pot), _t(w1), _t(w2))
    kern = jax_pc.factored_masked_contract(
        jnp.asarray(pot), jnp.asarray(w1), jnp.asarray(w2), interpret=True
    )
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert float(np.abs(got.numpy() - np.asarray(kern)).max()) <= tol
    assert (got[0] == 0).all()


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
