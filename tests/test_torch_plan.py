"""The port compiles the same plans as the JAX package: ``Plan.to_json()``
is equal string for string, and each package loads the other's JSON."""

import pytest

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch import models


def _model(name):
    if name == "sprinkler":
        return models.sprinkler_model()
    if name == "grid4x4":
        return models.grid_mrf_model(4, 4, seed=0)
    return getattr(models, name)(seed=0)


MODELS = ["sprinkler", "grid4x4", "alarm_like", "insurance_like",
          "hailfinder_like"]


@pytest.mark.parametrize("name", MODELS)
def test_plan_json_matches_jax(name):
    factors, sizes, _ = _model(name)
    ours = jt.compile_plan(factors, sizes).to_json()
    theirs = jt_jax.compile_plan(factors, sizes).to_json()
    assert ours == theirs


@pytest.mark.parametrize("name", ["sprinkler", "alarm_like"])
def test_plan_from_json_loads_the_other_package(name):
    from junctiontree_tpu.schedule import plan_from_json as jax_from_json

    factors, sizes, _ = _model(name)
    js_jax = jt_jax.compile_plan(factors, sizes).to_json()
    js_torch = jt.compile_plan(factors, sizes).to_json()
    ours = jt.plan_from_json(js_jax)
    assert ours.to_json() == js_jax
    assert ours.tree.topo_order == jax_from_json(js_jax).tree.topo_order
    assert jax_from_json(js_torch).to_json() == js_torch


def test_native_backend_not_ported():
    factors, sizes, _ = models.sprinkler_model()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jt.compile_plan(factors, sizes, backend="native")
