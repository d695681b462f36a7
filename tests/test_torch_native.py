"""The port's native (C++) plan compiler case for case with
``tests/test_native.py``: structures equal to the port's Python compiler
and to the JAX package's compilers, the plan properties, disconnected
components, inference through a native plan (against the brute force, rtol
1e-9 in float64), and the ``auto`` threshold; plus where the library is
built and that the JAX package's library is never loaded."""

import os

import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch import native
from junctiontree_tpu_torch.schedule import compile_plan

from .util import (
    brute_force_marginals,
    chain_bn,
    check_running_intersection,
    check_triangulation,
    grid_mrf,
    random_factor_graph,
    random_values,
)

@pytest.fixture(autouse=True)
def _needs_gxx():
    if not native.available():
        pytest.skip("native compiler unavailable (no g++)")


@pytest.mark.parametrize("seed", range(10))
def test_native_matches_python(seed):
    factors, sizes = random_factor_graph(seed + 100, n_vars=10, n_factors=14)
    a = compile_plan(factors, sizes, backend="python")
    b = compile_plan(factors, sizes, backend="native")
    assert a.clique_vars == b.clique_vars
    assert a.tri.factor_to_maxclique == b.tri.factor_to_maxclique
    assert a.tri.elimination_order == b.tri.elimination_order
    assert a.tree.separators == b.tree.separators
    assert a.tree.edges == b.tree.edges
    assert b.to_json() == jt_jax.compile_plan(factors, sizes, backend="native").to_json()


@pytest.mark.parametrize(
    "case", [chain_bn(40), grid_mrf(4, 4), grid_mrf(3, 5, card=3)]
)
def test_native_plan_properties(case):
    factors, sizes = case
    plan = compile_plan(factors, sizes, backend="native")
    check_triangulation(plan)
    check_running_intersection(plan)


def test_native_disconnected_components():
    plan = compile_plan([["a"], ["b"], ["c", "d"]], {"a": 2, "b": 3, "c": 2, "d": 2},
                        backend="native")
    assert len(plan.tree.edges) == plan.tri.num_cliques - 1
    check_running_intersection(plan)


def test_native_end_to_end_inference():
    factors, sizes = grid_mrf(3, 4)
    values = random_values(factors, sizes, seed=2)
    plan = compile_plan(factors, sizes, backend="native")
    out = jt.Engine(plan, device="cpu", dtype=torch.float64).propagate(values)
    expect = brute_force_marginals(factors, sizes, values, factors)
    for o, e in zip(out, expect):
        np.testing.assert_allclose(o, e, rtol=1e-9, atol=1e-12)


def test_auto_backend_threshold(monkeypatch):
    """``auto`` calls the native compiler from 512 variables up, and only
    then; both plans equal the JAX package's ``auto`` plans."""
    calls = []
    real = native.native_compile

    def spy(f, s):
        calls.append(len(s))
        return real(f, s)

    monkeypatch.setattr(native, "native_compile", spy)
    small = compile_plan(*chain_bn(5), backend="auto")
    assert calls == []
    big = compile_plan(*chain_bn(600), backend="auto")
    assert calls == [600]
    assert small.tri.num_cliques == 4
    assert big.tri.num_cliques == 599
    for f, s in (chain_bn(5), chain_bn(600)):
        assert compile_plan(f, s).to_json() == jt_jax.compile_plan(f, s).to_json()


def test_native_builds_its_own_library(monkeypatch):
    """The library is built from the port's own source into the port's
    ignored ``_build/``, under a name keyed by the source's hash; without
    ``g++`` it is unavailable and ``backend="native"`` raises."""
    path = native.library_path()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert os.path.dirname(path) == os.path.join(pkg, "_build")
    assert os.path.exists(path)
    with open(os.path.join(os.path.dirname(native.__file__), "jt_compile.cpp"),
              "rb") as f:
        ours = f.read()
    jax_src = os.path.join(os.path.dirname(jt_jax.__file__), "native", "jt_compile.cpp")
    with open(jax_src, "rb") as f:
        assert f.read() == ours  # a copy of the JAX package's compiler
    assert native.get_lib()._name == path  # never the JAX package's .so
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    monkeypatch.setattr(native, "library_path", lambda: path + ".missing")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    assert native.native_compile([[0, 1]], [2, 2]) is None
    factors, sizes = chain_bn(5)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        compile_plan(factors, sizes, backend="native")
    assert compile_plan(*chain_bn(600), backend="auto").tri.num_cliques == 599
