"""Data parallelism of the port, case for case with ``tests/test_sharding.py``:
the JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``), the
port on a mesh of ``["cpu"] * 8``.  Both run in float64, held to each other
at rtol 1e-9 (the sharded port to the unsharded port at rtol 1e-12, as the
JAX tests hold theirs).  Also ``Engine.shard_batch`` on every batched
surface, ``chunk=`` on a sharded engine (held to the contract, not to the
JAX package, which drops ``chunk`` there), ``LoopyEngine(mesh=)`` against
the JAX package's, and the parallel package's names against the JAX
package's."""

import ast
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.parallel.batch import (
    make_sharded_query as jax_make_sharded_query,
    make_sharded_query_shardmap as jax_make_sharded_query_shardmap,
)
from junctiontree_tpu.parallel.mesh import make_mesh as jax_make_mesh
from junctiontree_tpu_torch.models import grid_mrf_model
from junctiontree_tpu_torch.parallel import batch as batch_mod
from junctiontree_tpu_torch.parallel.batch import (
    make_sharded_query,
    make_sharded_query_shardmap,
)
from junctiontree_tpu_torch.parallel.mesh import Mesh, make_mesh

from .util import brute_force_marginals

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def setup():
    factors, sizes, values = grid_mrf_model(3, 3, seed=2)
    plan = jt.compile_plan(factors, sizes)
    eng = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    evs = jt.random_evidence_batch(plan, 16, ["g0_0", "g1_1", "g2_2"], seed=5)
    mb = jt.batch_masks(plan, evs)
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    return factors, sizes, values, plan, eng, evs, mb, jeng


def test_devices_available(monkeypatch):
    """The CPU mesh holds 8 devices like the JAX tests' platform; without a
    card the default mesh raises instead of falling to the CPU."""
    assert len(jax.devices()) == 8
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape == {"batch": 8, "model": 1}
    assert mesh.devices.shape == (8, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n_batch=4, n_model=4, devices=CPU8)


def test_sharded_query_matches_unsharded(setup):
    factors, sizes, values, plan, eng, evs, mb, jeng = setup
    fn = make_sharded_query(plan, make_mesh(devices=CPU8))
    margs_s, z_s = fn(eng._pots, mb)

    margs_u, z_u = eng.query_batch(mb)
    np.testing.assert_allclose(z_s, z_u, rtol=1e-12)
    for a, b in zip(margs_s, margs_u):
        np.testing.assert_allclose(a, b, rtol=1e-12)

    jfn = jax_make_sharded_query(jeng.plan, jax_make_mesh())
    jmargs, jz = jfn(jeng._pots, [jnp.asarray(m) for m in mb])
    np.testing.assert_allclose(z_s, np.asarray(jz), rtol=1e-9)
    for a, b in zip(margs_s, jmargs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9)

    # and against the oracle for one batch element
    var_list = list(sizes)
    expect = brute_force_marginals(
        factors, sizes, values, [[v] for v in var_list], evidence=evs[3]
    )
    for i, v in enumerate(var_list):
        vid = plan.table.id_of(v)
        m = margs_s[vid][3].numpy()
        np.testing.assert_allclose(m / m.sum(), expect[i] / expect[i].sum(),
                                   rtol=1e-6, atol=1e-9)


def test_sharded_output_actually_sharded(setup, monkeypatch):
    """Each of the 8 devices serves its own 2 rows: one per-row program
    (``torch.vmap``) per device."""
    _, _, _, plan, eng, _, mb, _ = setup
    rows = []
    vmap = torch.vmap

    def counting_vmap(f, *a, **k):
        g = vmap(f, *a, **k)

        def run(masks):
            rows.append(int(masks[0].shape[0]))
            return g(masks)
        return run

    monkeypatch.setattr(batch_mod.torch, "vmap", counting_vmap)
    _, z = make_sharded_query(plan, make_mesh(devices=CPU8))(eng._pots, mb)
    assert rows == [2] * 8 and z.shape == (16,)


@pytest.mark.parametrize("n_batch,n_model", [(8, 1), (4, 2), (2, 1)])
def test_mesh_shapes(setup, n_batch, n_model):
    _, _, _, plan, eng, _, mb, _ = setup
    mesh = make_mesh(n_batch=n_batch, n_model=n_model, devices=CPU8)
    assert mesh.shape == {"batch": n_batch, "model": n_model}
    margs, z = make_sharded_query(plan, mesh)(eng._pots, mb)
    margs_u, z_u = eng.query_batch(mb)
    np.testing.assert_allclose(z, z_u, rtol=1e-12)
    with pytest.raises(ValueError, match="does not split"):
        make_sharded_query(plan, make_mesh(3, 1, devices=CPU8))(eng._pots, mb)


def test_shardmap_collective_aggregate(setup):
    _, _, _, plan, eng, _, mb, jeng = setup
    fn = make_sharded_query_shardmap(plan, make_mesh(devices=CPU8))
    margs, z, mean_logz = fn(eng._pots, mb)
    _, z_u = eng.query_batch(mb)
    np.testing.assert_allclose(z, z_u, rtol=1e-12)
    np.testing.assert_allclose(float(mean_logz), np.log(z_u.numpy()).mean(),
                               rtol=1e-10)
    jfn = jax_make_sharded_query_shardmap(jeng.plan, jax_make_mesh())
    _, _, jmean = jfn(jeng._pots, [jnp.asarray(m) for m in mb])
    np.testing.assert_allclose(float(mean_logz), float(jmean), rtol=1e-9)


def test_engine_shard_batch_posterior_and_map(setup):
    """``Engine.shard_batch``: posterior_batch and map_assignment_batch
    split their rows over the mesh; results equal the unsharded engine's
    and the JAX package's sharded engine's."""
    factors, sizes, values, plan, eng, evs, mb, jeng = setup
    sp = jt.batch_masks_sparse(plan, evs)
    post_u, logz_u = eng.posterior_batch(sp)

    eng2 = jt.Engine(plan, device="cpu", dtype=torch.float64) \
        .set_potentials(values)
    assert eng2.shard_batch(make_mesh(devices=CPU8)) is eng2
    post_s, logz_s = eng2.posterior_batch(sp)
    np.testing.assert_allclose(logz_s, logz_u, rtol=1e-12)
    for a, b in zip(post_s, post_u):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    assert len(eng2._replicas) == 1   # eight devices, all "cpu": one replica

    jeng2 = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values).shard_batch(jax_make_mesh())
    jpost, jlogz = jeng2.posterior_batch(
        {k: jnp.asarray(v) for k, v in sp.items()})
    np.testing.assert_allclose(logz_s, np.asarray(jlogz), rtol=1e-9)
    for a, b in zip(post_s, jpost):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-15)

    B = 16
    m = np.full((B, 2), -np.inf, dtype=np.float32)
    m[np.arange(B), np.arange(B) % 2] = 0.0
    a_u, s_u = eng.map_assignment_batch({"g0_0": m})
    a_s, s_s = eng2.map_assignment_batch({"g0_0": m})
    np.testing.assert_allclose(s_s, s_u, rtol=1e-12)
    np.testing.assert_array_equal(a_s, a_u)
    ja, js = jeng2.map_assignment_batch({"g0_0": m})
    np.testing.assert_allclose(s_s, np.asarray(js), rtol=1e-9)


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_engine_shard_batch_honours_chunk(setup, chunk):
    """``chunk=`` on a sharded engine bounds each device's slices and gives
    the unchunked, unsharded results (the JAX package drops ``chunk`` on
    sharded engines; the port keeps it)."""
    _, _, values, plan, eng, evs, _, _ = setup
    sp = jt.batch_masks_sparse(plan, evs)
    eng2 = jt.Engine(plan, device="cpu", dtype=torch.float64) \
        .set_potentials(values).shard_batch(make_mesh(4, 1, devices=CPU8))
    post_u, logz_u = eng.posterior_batch(sp)
    post_s, logz_s = eng2.posterior_batch(sp, chunk=chunk)
    np.testing.assert_allclose(logz_s, logz_u, rtol=1e-12)
    for a, b in zip(post_s, post_u):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    logm = {k: np.where(v > 0, 0.0, -np.inf) for k, v in sp.items()}
    a_u, s_u = eng.map_assignment_batch(logm)
    a_s, s_s = eng2.map_assignment_batch(logm, chunk=chunk)
    np.testing.assert_array_equal(a_s, a_u)
    np.testing.assert_allclose(s_s, s_u, rtol=1e-12)
    with pytest.raises(ValueError, match="chunk"):
        eng2.posterior_batch(sp, chunk=0)


def test_engine_shard_batch_every_surface(setup):
    """query_batch, entropy_batch, joint_marginal_batch, top-k, the
    incremental session and uneven row blocks (B = 5 over 8 devices) on a
    sharded engine equal the unsharded engine's results."""
    _, _, values, plan, eng, evs, mb, _ = setup
    sp = jt.batch_masks_sparse(plan, evs)
    eng2 = jt.Engine(plan, device="cpu", dtype=torch.float64) \
        .set_potentials(values).shard_batch(make_mesh(devices=CPU8))
    for a, b in zip(eng2.query_batch(mb)[0], eng.query_batch(mb)[0]):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    for a, b in zip(eng2.entropy_batch(sp), eng.entropy_batch(sp)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    for a, b in zip(eng2.joint_marginal_batch(["g0_1", "g2_1"], sp),
                    eng.joint_marginal_batch(["g0_1", "g2_1"], sp)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    logm = {k: np.where(v > 0, 0.0, -np.inf) for k, v in sp.items()}
    for a, b in zip(eng2.top_k_assignments_batch(logm, k=3),
                    eng.top_k_assignments_batch(logm, k=3)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    few = {k: v[:5] for k, v in sp.items()}
    for a, b in zip(eng2.posterior_batch(few)[0], eng.posterior_batch(few)[0]):
        assert a.shape == (5, 2)
        np.testing.assert_allclose(a, b, rtol=1e-12)
    base = {"g0_0": np.ones((16, 2))}
    upd = {"g0_0": sp["g0_0"]}
    got = eng2.incremental(base).query(upd, ["g1_1", "g2_2"])
    want = eng.incremental(base).query(upd, ["g1_1", "g2_2"])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_loopy_engine_mesh_matches_jax():
    """``LoopyEngine(mesh=)`` splits the evidence batch over the mesh: the
    same iterations and results as the unsplit engine (float32: beliefs
    within 1e-6, logZ within 1e-5, sums over narrower tensors) and as the
    JAX package's ``LoopyEngine(mesh=)`` (atol 2e-5, as
    ``tests/test_torch_approx.py`` holds the two packages)."""
    from junctiontree_tpu import approx as japprox

    factors, sizes, values = grid_mrf_model(4, 4, seed=3)
    B = 16
    rng = np.random.default_rng(2)
    masks = {}
    for name in ("g0_0", "g2_3", "g3_1"):
        m = np.zeros((B, 2), dtype=np.float32)
        m[np.arange(B), rng.integers(0, 2, B)] = 1.0
        masks[name] = m
    one = jt.LoopyEngine(factors, sizes, values, device="cpu", tol=1e-5)
    split = jt.LoopyEngine(factors, sizes, values, tol=1e-5,
                           mesh=make_mesh(devices=CPU8))
    assert split.device == torch.device("cpu")
    p1, l1, i1 = one.posterior_batch(masks)
    p2, l2, i2 = split.posterior_batch(masks)
    assert i1["iters"] == i2["iters"]
    np.testing.assert_allclose(l2, l1, rtol=0, atol=1e-5)
    for a, b in zip(p2, p1):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    jeng = japprox.LoopyEngine(factors, sizes, values, tol=1e-5,
                               mesh=jax_make_mesh())
    jp, jl, ji = jeng.posterior_batch(masks)
    assert ji["iters"] == i2["iters"]
    np.testing.assert_allclose(l2, np.asarray(jl), atol=2e-5)
    for v in range(len(sizes)):
        np.testing.assert_allclose(p2[v], np.asarray(jp[v]), atol=2e-5)
    a1, s1, _ = one.map_assignment_batch(masks)
    a2, s2, _ = split.map_assignment_batch(masks)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_allclose(s1, s2, rtol=1e-12)


def test_package_exports_cover_jax():
    """Every name the JAX package exports, the port exports; the parallel
    package is reachable from the top."""
    assert set(jt_jax.__all__) <= set(jt.__all__), sorted(
        set(jt_jax.__all__) - set(jt.__all__))
    assert jt.parallel.make_mesh is make_mesh


@pytest.mark.parametrize("module", ["mesh", "batch", "tp", "forest",
                                    "multihost"])
def test_parallel_names_match_jax(module):
    """Every public name that a JAX ``parallel`` module defines exists in
    the port's module of the same name."""
    jmod = importlib.import_module(f"junctiontree_tpu.parallel.{module}")
    mod = importlib.import_module(f"junctiontree_tpu_torch.parallel.{module}")
    own = set()
    for node in ast.parse(inspect.getsource(jmod)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            own.add(node.name)
        elif isinstance(node, ast.Assign):
            own.update(t.id for t in node.targets if isinstance(t, ast.Name))
    own = {k for k in own if not k.startswith("_")}
    assert own
    assert own <= set(dir(mod)), sorted(own - set(dir(mod)))
    assert isinstance(make_mesh(devices=CPU8), Mesh)
