"""The factored big-clique contraction: the port's plain version against the
JAX package's Pallas kernel (interpret mode) and its einsum reference, the
surrounding weight-group logic against JAX ``big_clique_sep_message``.  The
CUDA kernel itself is tested on the GPU by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize(
    "B,R1,R2,C",
    [(4096, 64, 4096, 1), (4096, 32, 2048, 2), (5, 1, 7, 1), (3, 4, 33, 300)],
)
def test_launch_config_covers_every_output_and_r2(B, R1, R2, C):
    cfg = fc.launch_config(B, R1, R2, C, n_sm=132)
    assert cfg["tc"] in (1, 2, 4, 8)
    assert cfg["n_c"] * cfg["tc"] >= C > (cfg["n_c"] - 1) * cfg["tc"]
    assert cfg["n_b"] * fc.TB >= B > (cfg["n_b"] - 1) * fc.TB
    k = cfg["k_per_split"]
    assert k % fc.KT == 0
    # every r2 split holds at least one element, and together they cover R2
    assert (cfg["nsplit"] - 1) * k < R2 <= cfg["nsplit"] * k


def test_cpu_wrapper_launches_nothing():
    pot, w1, w2 = torch.ones(2, 3, 1), torch.ones(4, 2), torch.ones(4, 3)
    before = fc.factored_masked_contract.launches
    out = fc.factored_masked_contract(pot, w1, w2)
    assert fc.factored_masked_contract.launches == before
    assert torch.equal(out, torch.full((4, 1), 6.0))
