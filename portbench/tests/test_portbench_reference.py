"""The float64 reference against brute-force enumeration of the joint."""

import itertools

import numpy as np
import pytest
import torch

from junctiontree_tpu_torch.models import sprinkler_model
from portbench import reference
from portbench.models import random_bayesnet

CPU = torch.device("cpu")


def _joint(factors, sizes, values):
    names = list(sizes)
    shape = [sizes[v] for v in names]
    joint = np.ones(shape)
    for scope, val in zip(factors, values):
        idx = [names.index(v) for v in scope]
        perm = np.argsort(idx)
        t = np.transpose(np.asarray(val, dtype=np.float64), perm)
        full = [1] * len(names)
        for ax, i in enumerate(sorted(idx)):
            full[i] = t.shape[ax]
        joint = joint * t.reshape(full)
    return names, joint


def _brute(factors, sizes, values, masks):
    """Per row: posteriors, logZ and the best log score by enumeration."""
    names, joint = _joint(factors, sizes, values)
    rows = len(next(iter(masks.values())))
    post = {v: np.zeros((rows, sizes[v])) for v in names}
    logz, best = np.zeros(rows), np.zeros(rows)
    for b in range(rows):
        j = joint.copy()
        for v, m in masks.items():
            shape = [1] * len(names)
            shape[names.index(v)] = sizes[v]
            j = j * m[b].reshape(shape)
        z = j.sum()
        with np.errstate(divide="ignore"):
            logz[b] = np.log(z)
            best[b] = np.log(j.max())
        for i, v in enumerate(names):
            axes = tuple(a for a in range(len(names)) if a != i)
            post[v][b] = j.sum(axis=axes) / z if z > 0 else 0.0
    return post, logz, best


def _models():
    f, s, v = sprinkler_model()
    yield "sprinkler", f, s, v, ["wet_grass"]
    cfg = dict(nodes=10, max_in_degree=3, cards=[2, 3, 4], cpd_offset=0.05,
               model_seed=4)
    f, s, v = random_bayesnet.build(cfg)
    yield "net10", f, s, v, ["n1", "n4", "n9"]


def _masks(sizes, observed, rows, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for v in observed:
        m = np.zeros((rows, sizes[v]))
        m[np.arange(rows), rng.integers(sizes[v], size=rows)] = 1.0
        out[v] = m
    out[observed[0]][1] = 0.0          # row 1: impossible evidence
    return out


@pytest.mark.parametrize("model", list(_models()), ids=lambda m: m[0])
def test_posteriors_and_logz_match_enumeration(model):
    _, f, s, v, observed = model
    masks = _masks(s, observed, 6, 1)
    post, logz, _ = _brute(f, s, v, masks)
    got, got_z = reference.Reference(f, s, v, CPU).posteriors(masks)
    assert np.isneginf(got_z[1]) and np.isneginf(logz[1])
    np.testing.assert_allclose(got_z, logz, rtol=1e-12, atol=1e-12)
    for k in post:
        np.testing.assert_allclose(got[k], post[k], rtol=0, atol=1e-13)
        assert not got[k][1].any()


@pytest.mark.parametrize("model", list(_models()), ids=lambda m: m[0])
def test_map_decode_matches_enumeration(model):
    _, f, s, v, observed = model
    masks = _masks(s, observed, 6, 2)
    _, _, best = _brute(f, s, v, masks)
    with np.errstate(divide="ignore"):
        log_masks = {k: np.log(m) for k, m in masks.items()}
    ref = reference.Reference(f, s, v, CPU, semiring="max")
    assign, score = ref.map_decode(log_masks)
    assert np.isneginf(score[1])
    np.testing.assert_allclose(score, best, rtol=1e-12, atol=1e-12)
    # each feasible row's assignment attains the best score
    own = reference.score_assignments(f, v, assign, log_masks)
    feasible = np.isfinite(best)
    np.testing.assert_allclose(own[feasible], best[feasible], rtol=1e-12)
    assert set(assign) == set(s)


def test_running_intersection_of_the_own_tree():
    cfg = dict(nodes=30, max_in_degree=3, cards=[2, 3], cpd_offset=0.05,
               model_seed=9)
    f, s, _ = random_bayesnet.build(cfg)
    ref = reference.Reference(f, s)
    for v in s:
        holders = {c for c, cl in enumerate(ref.cliques) if v in cl}
        # the cliques holding v form a connected subtree
        tops = [c for c in holders if ref.parent[c] not in holders]
        assert len(tops) == 1
    for scope in f:
        assert any(set(scope) <= set(c) for c in ref.cliques)


def test_operations_count_every_message_and_marginal():
    names = [f"x{i}" for i in range(4)]
    f = [names[:2], names[1:3], names[2:]]
    s = {n: 2 for n in names}
    ref = reference.Reference(f, s)
    assert sorted(len(c) for c in ref.cliques) == [2, 2, 2]
    # a path of three 4-state cliques: 4 messages, 4 marginals, 1 partition
    assert ref.operations(3) == 2 * 3 * 4 * (4 + 4 + 1)


def test_to_tf32_keeps_ten_mantissa_bits_rounded_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      1.0 + 2**-12, -3.0, 0.0, float("inf"), float("-inf")])
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0, -3.0,
                         0.0, float("inf"), float("-inf")])
    assert torch.equal(reference.to_tf32(x), want)
    r = torch.rand(10000) + 0.5
    rel = ((reference.to_tf32(r) - r) / r).abs()
    assert rel.max() <= 2**-11 and rel.max() > 2**-12
