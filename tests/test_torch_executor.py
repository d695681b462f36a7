"""The unbatched parity path of the port (``propagate``, ``query``) against
the JAX package in float64 and against the brute-force oracle, with the
serving contract's probes: impossible evidence, full instantiation, the
sprinkler posterior and querying before ``set_potentials``."""

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.models import alarm_like, grid_mrf_model, sprinkler_model

from .util import brute_force_marginals, random_factor_graph, random_values


def _case(name):
    if name == "sprinkler":
        return sprinkler_model()
    if name == "grid3x3":
        return grid_mrf_model(3, 3, seed=1)
    factors, sizes = random_factor_graph(seed=int(name[-1]))
    return factors, sizes, random_values(factors, sizes, seed=7)


@pytest.mark.parametrize("name", ["sprinkler", "grid3x3", "random2", "random5"])
def test_propagate_matches_jax_and_oracle(name):
    factors, sizes, values = _case(name)
    got = jt.create_junction_tree(factors, sizes).propagate(
        values, device="cpu")
    want = jt_jax.create_junction_tree(factors, sizes).propagate(values)
    oracle = brute_force_marginals(factors, sizes, values, factors)
    assert len(got) == len(values)
    for g, w, o, v in zip(got, want, oracle, values):
        assert g.shape == np.shape(v)
        np.testing.assert_allclose(g, w, rtol=1e-9)
        np.testing.assert_allclose(g, o, rtol=1e-9)


@pytest.mark.parametrize("name", ["sprinkler", "alarm"])
def test_query_matches_jax_and_oracle(name):
    if name == "sprinkler":
        factors, sizes, values = sprinkler_model()
        evidence = {"wet_grass": 1, "cloudy": 0}
    else:
        factors, sizes, values = alarm_like(seed=3)
        evidence = {"n0": 0, "n10": 1, "n30": 0}
    tree = jt.create_junction_tree(factors, sizes)
    eng = tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)
    margs, z = eng.query(evidence)
    jmargs, jz = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values).query(evidence)
    labels = [tree.plan.table.label_of(v) for v in range(tree.plan.num_vars)]
    oracle = brute_force_marginals(
        factors, sizes, values, [[x] for x in labels], evidence=evidence
    )
    np.testing.assert_allclose(z, jz, rtol=1e-9)
    np.testing.assert_allclose(z, oracle[0].sum(), rtol=1e-9)
    for m, jm, o in zip(margs, jmargs, oracle):
        np.testing.assert_allclose(m, np.asarray(jm), rtol=1e-9, atol=1e-15)
        np.testing.assert_allclose(m, o / o.sum(), rtol=1e-9, atol=1e-15)


def _sprinkler_engine():
    factors, sizes, values = sprinkler_model()
    tree = jt.create_junction_tree(factors, sizes)
    return tree, tree.engine(device="cpu", dtype=torch.float64).set_potentials(values)


def test_sprinkler_rain_given_wet_grass():
    tree, eng = _sprinkler_engine()
    post, p_wet = eng.query({"wet_grass": 1})
    rain = post[tree.plan.table.id_of("rain")]
    assert round(float(rain[1]), 4) == 0.7079
    assert round(p_wet, 4) == 0.6471


def test_impossible_evidence_gives_zero_without_nan():
    """P(wet_grass=1 | sprinkler=0, rain=0) = 0 in the CPT."""
    _, eng = _sprinkler_engine()
    margs, z = eng.query({"sprinkler": 0, "rain": 0, "wet_grass": 1})
    assert z == 0.0
    for m in margs:
        assert not np.isnan(m).any()
        assert (m == 0).all()


def test_full_instantiation_gives_joint_probability():
    factors, sizes, values = sprinkler_model()
    _, eng = _sprinkler_engine()
    state = {"cloudy": 1, "sprinkler": 0, "rain": 1, "wet_grass": 1}
    _, z = eng.query(state)
    joint = 1.0
    for f, v in zip(factors, values):
        joint *= v[tuple(state[x] for x in f)]
    np.testing.assert_allclose(z, joint, rtol=1e-12)


def test_bad_queries_raise():
    factors, sizes, values = sprinkler_model()
    eng = jt.create_junction_tree(factors, sizes).engine(device="cpu")
    with pytest.raises(RuntimeError, match="set_potentials"):
        eng.query({"rain": 1})
    eng.set_potentials(values)
    with pytest.raises(KeyError):
        eng.query({"no_such_var": 0})
    with pytest.raises(ValueError, match="out of range"):
        eng.query({"rain": 2})
    with pytest.raises(ValueError, match="shape"):
        eng.set_potentials([np.ones(3)] + values[1:])


@pytest.mark.parametrize("entry", ["Engine", "engine", "propagate", "engine_from_numpy"])
def test_default_device_is_the_card_and_raises_without_one(entry, monkeypatch):
    """With no ``device`` every entry point means CUDA device 0; where there
    is none it raises and names the ``device="cpu"`` way out."""
    from junctiontree_tpu_torch.executor import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    factors, sizes, values = sprinkler_model()
    tree = jt.create_junction_tree(factors, sizes)
    calls = {
        "Engine": lambda: Engine(tree.plan),
        "engine": lambda: tree.engine(),
        "propagate": lambda: tree.propagate(values),
        "engine_from_numpy": lambda: jt.engine_from_numpy(
            tree.plan.to_json(),
            tree.engine(device="cpu").set_potentials(values)._pots,
        ),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
