"""The port compiles the same plans as the JAX package: ``Plan.to_json()``
is equal string for string, and each package loads the other's JSON.  The
chain of 600 and the star of 1,000 leaves have 512 variables or more, so
``backend="auto"`` compiles them with the native compiler in both packages;
they are also held to the JAX package's Python compiler."""

import pytest

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch import models


def _model(name):
    if name == "sprinkler":
        return models.sprinkler_model()
    if name == "grid4x4":
        return models.grid_mrf_model(4, 4, seed=0)
    if name == "chain600":
        return models.chain_bn_model(600, seed=1)
    if name == "star1000":
        return models.star_bn_model(1000, card=3)
    return getattr(models, name)(seed=0)


MODELS = ["sprinkler", "grid4x4", "alarm_like", "insurance_like",
          "hailfinder_like", "chain600", "star1000"]


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


@pytest.mark.parametrize("name", ["chain600", "star1000"])
def test_native_plan_matches_jax_python_compiler(name):
    """Above the threshold the port's ``auto`` (native) plan equals the JAX
    package's pure-Python plan, and the port's own Python compiler's."""
    factors, sizes, _ = _model(name)
    ours = jt.compile_plan(factors, sizes).to_json()
    assert ours == jt_jax.compile_plan(factors, sizes, backend="python").to_json()
    if name == "chain600":  # the star's Python compile takes seconds
        assert ours == jt.compile_plan(factors, sizes, backend="python").to_json()
