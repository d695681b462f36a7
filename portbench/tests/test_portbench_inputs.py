"""The frozen generators, the evidence and the roofline arithmetic give what
the program's own helpers and a count by hand give today."""

import json
import os
import sys

import numpy as np
import pytest

import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.models import hailfinder_like
from portbench import core, evidence, roofline
from portbench.models import dense_clique, random_bayesnet

CONFIGS = os.path.join(core.HERE, "configs")


# the generator's parameters at which it gives the program's hailfinder_like
# (seed 0): no cell runs it, the tiny cells of the tests do
RANDOM_NET = {"generator": "random_bayesnet", "nodes": 56, "max_in_degree": 4,
              "cards": [2, 3, 4, 5, 6], "cpd_offset": 0.05, "model_seed": 0,
              "dtype": "float32"}


def _cfg(name):
    if name == "random_net56":
        return RANDOM_NET
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


def _same(a, b):
    fa, sa, va = a
    fb, sb, vb = b
    assert fa == fb and sa == sb and len(va) == len(vb)
    for x, y in zip(va, vb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_random_bayesnet_is_hailfinder_like_seed_0():
    _same(random_bayesnet.build(_cfg("random_net56")),
          hailfinder_like(seed=0))


def test_bigclique18_is_the_card_scripts_big_clique():
    sys.path.insert(0, core.ROOT)
    import chip_smoke

    f, s, v, _ = chip_smoke.big_clique_model()
    _same(dense_clique.build(_cfg("bigclique18")), (f, s, v))


@pytest.mark.parametrize("seed",
                         [0, 7, [3, 5], [2**31 + 9, 7], 2**33 + 1])
@pytest.mark.parametrize("model", ["random_net56", "bigclique18"])
def test_evidence_is_random_evidence_batch(seed, model):
    cfg = _cfg(model)
    gen = random_bayesnet if "nodes" in cfg else dense_clique
    factors, sizes, _ = gen.build(cfg)
    plan = jt.create_junction_tree(factors, sizes).plan
    observed = list(sizes)[::3]
    want = jt.batch_masks_sparse(
        plan, jt.random_evidence_batch(plan, 300, observed, seed=seed))
    got = evidence.mask_batch(seed, 300, observed, sizes)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_draw_states_falls_back_to_the_scalar_loop_exactly():
    # a card of 2**31 + 1 rejects about half the words: the fallback path
    cards = [2**31 + 1, 3]
    assert np.array_equal(evidence.draw_states(5, 40, cards),
                          evidence._scalar_states(5, 40, cards))


def test_pool_batches_differ_and_repeat_from_the_seed():
    mix = {"batch": 64, "observed": ["a", "b"], "impossible_rows": [1],
           "pool": 3}
    sizes = {"a": 3, "b": 5}
    p1, p2 = evidence.pool(2**32 + 3, mix, sizes), evidence.pool(2**32 + 3,
                                                                 mix, sizes)
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(p1, p2) for k in x)
    assert not np.array_equal(p1[0]["b"], p1[1]["b"])
    assert all(not b["a"][1].any() and b["b"][1].sum() == 1 for b in p1)
    lm = evidence.log_masks(p1[0])
    assert np.isneginf(lm["a"][1]).all() and (lm["b"][0].max() == 0.0)


@pytest.mark.parametrize("shape", [(64, 2048, 2, 4096), (64, 4096, 1, 4096)])
def test_k1_roofline_by_hand(shape):
    R1, R2, C, B = shape
    # f32 operands as the route hands them: pot [R1, R2, C], w1 [B, R1],
    # w2 [B, R2] expanded, out [B, C]
    pot, w1, w2, out = 4 * R1 * R2 * C, 4 * B * R1, 4 * B * R2, 4 * B * C
    ops, nbytes, secs, by = roofline.k1_call(R1, R2, C, B, pot, w1, w2, out)
    assert ops == 2 * B * R1 * R2 * C == 2147483648
    hand_bytes = {(64, 2048, 2, 4096): 1048576 + 1048576 + 33554432 + 32768,
                  (64, 4096, 1, 4096): 1048576 + 1048576 + 67108864 + 16384}
    assert nbytes == hand_bytes[shape]
    assert secs == pytest.approx(max(ops / 989e12, nbytes / 3.35e12), rel=0)
    assert by == "bytes"
    # the same operations at bf16 storage divide by the same 989 TFLOP/s
    ops16, _, _, _ = roofline.k1_call(R1, R2, C, B, pot // 2, w1, w2 // 2, out)
    assert ops16 / roofline.PEAK_FLOPS == ops / 989e12
