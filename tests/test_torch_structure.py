"""``junctiontree_tpu_torch.structure`` case for case with
``tests/test_structure.py``, on the same seeded data as the JAX package:
pairwise counts are sums of 0/1 products and equal exactly, mutual
information and CPDs are host float64 code and agree to rtol 1e-12."""

import itertools

import numpy as np
import pytest
import torch

import junctiontree_tpu_torch as jt
from junctiontree_tpu import structure as jstructure
from junctiontree_tpu_torch.structure import (
    _max_spanning_tree,
    chow_liu,
    mutual_information,
    pairwise_counts,
)

from .test_structure import _sample_tree_bn


def test_pairwise_counts_match_numpy_and_jax():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 3, size=(200, 4))
    cards = [3, 3, 3, 3]
    counts = pairwise_counts(data, cards, device="cpu")
    for v in range(4):
        for w in range(4):
            want = np.zeros((3, 3))
            for a, b in zip(data[:, v], data[:, w]):
                want[a, b] += 1
            np.testing.assert_array_equal(counts[v, w], want)
    np.testing.assert_array_equal(counts, jstructure.pairwise_counts(data, cards))


def test_pairwise_counts_mixed_cards_and_range():
    data, cards, *_ = _sample_tree_bn(300, seed=4)
    counts = pairwise_counts(data, cards, device="cpu")
    assert counts.shape == (6, 6, 3, 3)
    np.testing.assert_array_equal(counts, jstructure.pairwise_counts(data, cards))
    assert counts[0, 2, 2:].sum() == 0  # padded cells stay zero
    with pytest.raises(ValueError, match="states"):
        pairwise_counts(np.array([[0, 3]]), [2, 2], device="cpu")


def test_mutual_information_independent_vs_coupled():
    rng = np.random.default_rng(5)
    n = 5000
    x = rng.integers(0, 2, n)
    y = x.copy()
    y[: n // 20] = 1 - y[: n // 20]
    z = rng.integers(0, 2, n)
    data = np.stack([x, y, z], axis=1)
    counts = pairwise_counts(data, [2, 2, 2], device="cpu")
    mi = mutual_information(counts, [2, 2, 2])
    assert mi[0, 1] > 10 * max(mi[0, 2], 1e-9)
    np.testing.assert_allclose(
        mi, jstructure.mutual_information(counts, [2, 2, 2]), rtol=1e-12)
    np.testing.assert_allclose(
        mutual_information(counts, [2, 2, 2], alpha=0.5),
        jstructure.mutual_information(counts, [2, 2, 2], alpha=0.5), rtol=1e-12)


def test_max_spanning_tree_matches_jax():
    w = np.random.default_rng(2).random((7, 7))
    w = w + w.T
    assert _max_spanning_tree(w) == jstructure._max_spanning_tree(w)


def test_chow_liu_recovers_tree_skeleton():
    data, cards, true_edges, *_ = _sample_tree_bn(4000, seed=1)
    factors, sizes, values, edges = chow_liu(data, cards=cards, device="cpu")
    assert set(frozenset(e) for e in edges) == true_edges
    for f, val in zip(factors, values):
        np.testing.assert_allclose(val.sum(axis=-1) if len(f) == 2 else val.sum(),
                                   1.0, atol=1e-9)
    jf, js, jv, je = jstructure.chow_liu(data, cards=cards)
    assert factors == jf and sizes == js and edges == je
    for a, b in zip(values, jv):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_chow_liu_end_to_end_inference():
    """Fitted model serves exact posteriors close to the generator's."""
    data, cards, _, p_root, cpds, parent = _sample_tree_bn(20000, seed=2)
    factors, sizes, values, edges = chow_liu(data, cards=cards, device="cpu")
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu").set_potentials(values)
    post, _ = eng.query({2: 1})
    got = np.asarray(post[tree.plan.table.id_of(0)])
    got = got / got.sum()
    num = np.zeros(2)
    for assign in itertools.product(*[range(c) for c in cards]):
        if assign[2] != 1:
            continue
        p = p_root[assign[0]]
        for v in range(1, 6):
            p *= cpds[(parent[v], v)][assign[parent[v]], assign[v]]
        num[assign[0]] += p
    np.testing.assert_allclose(got, num / num.sum(), atol=0.03)


def test_chow_liu_labels_and_defaults():
    data = np.random.default_rng(7).integers(0, 2, size=(100, 3))
    factors, sizes, values, edges = chow_liu(data, labels=["a", "b", "c"],
                                             device="cpu")
    assert set(sizes) == {"a", "b", "c"} and all(sizes[k] == 2 for k in sizes)
    tree = jt.create_junction_tree(factors, sizes)
    assert len(tree.propagate(values, device="cpu")) == len(factors)
    assert jt.chow_liu is chow_liu


def test_chow_liu_input_validation():
    with pytest.raises(ValueError):
        chow_liu(np.zeros((3,)), device="cpu")
    with pytest.raises(ValueError):
        chow_liu(np.zeros((3, 2), dtype=int), labels=["x"], device="cpu")


def test_chow_liu_single_variable():
    data = np.array([[0], [1], [1], [1]])
    factors, sizes, values, edges = chow_liu(data, labels=["v"], device="cpu")
    assert edges == []
    np.testing.assert_allclose(values[0].sum(), 1.0)
    assert values[0][1] > values[0][0]


def test_chow_liu_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chow_liu(np.zeros((3, 2), dtype=int))
