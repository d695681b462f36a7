"""Multi-process helpers of the port, case for case with
``tests/test_multihost.py``: the mesh, the placement of a process's rows,
the scaling report, data parallelism over 1, 2, 4 and 8 CPU devices (against
the JAX package's sharded query, float64, rtol 1e-9), and a real
two-process run over ``torch.distributed`` (gloo) through
``tests/_torch_multihost_worker.py``, which imports no JAX."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import junctiontree_tpu as jt_jax
import junctiontree_tpu_torch as jt
from junctiontree_tpu.parallel.batch import (
    make_sharded_query as jax_make_sharded_query,
)
from junctiontree_tpu.parallel.mesh import make_mesh as jax_make_mesh
from junctiontree_tpu.parallel.multihost import scaling_report as jax_report
from junctiontree_tpu_torch.models import grid_mrf_model
from junctiontree_tpu_torch.parallel.batch import make_sharded_query
from junctiontree_tpu_torch.parallel.mesh import make_mesh
from junctiontree_tpu_torch.parallel.multihost import (
    host_local_batch_to_global,
    initialize,
    make_multihost_mesh,
    scaling_report,
)

CPU8 = ["cpu"] * 8


def test_initialize_single_process_noop():
    initialize(num_processes=1)  # must not raise
    assert not torch.distributed.is_initialized()


def test_make_multihost_mesh_shapes(monkeypatch):
    mesh = make_multihost_mesh(n_model_per_host=2, devices=CPU8)
    assert mesh.shape["model"] == 2
    assert mesh.shape["batch"] == len(CPU8) // 2
    assert mesh.processes == 1
    with pytest.raises(ValueError):
        make_multihost_mesh(n_model_per_host=1024, devices=CPU8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_multihost_mesh()


def test_host_local_batch_to_global():
    mesh = make_multihost_mesh(devices=CPU8)
    x = np.arange(16, dtype=np.float32).reshape(16, 1)
    local = host_local_batch_to_global(mesh, [x])
    assert local.arrays[0].shape == (16, 1)
    np.testing.assert_allclose(local.arrays[0], x)
    assert (local.offset, local.total) == (0, 16)
    with pytest.raises(ValueError, match="rows"):
        host_local_batch_to_global(mesh, [x, x[:3]])


def test_scaling_report():
    rep = scaling_report({"1chip": (1, 100.0), "8chip": (8, 640.0)})
    assert rep["8chip"]["efficiency"] == pytest.approx(0.8)
    assert rep["1chip"]["efficiency"] == pytest.approx(1.0)
    assert scaling_report({}) == {}
    runs = {"a": (2, 150.0), "b": (1, 100.0), "c": (4, 310.0)}
    assert scaling_report(runs) == jax_report(runs)


def test_dp_results_identical_across_device_counts():
    """The sharded query gives the same results on 1, 2, 4 and 8 devices,
    and the JAX package's on the same number of devices."""
    factors, sizes, values = grid_mrf_model(3, 3, seed=1)
    plan = jt.compile_plan(factors, sizes)
    eng = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    B = 64
    evs = jt.random_evidence_batch(plan, B, ["g0_0", "g2_2"], seed=0)
    masks = jt.batch_masks(plan, evs)

    outs = {}
    for n in (1, 2, 4, 8):
        mesh = make_mesh(n_batch=n, n_model=1, devices=CPU8[:n])
        _, z = make_sharded_query(plan, mesh)(eng._pots, masks)
        outs[n] = z.numpy()
        jmesh = jax_make_mesh(n_batch=n, n_model=1, devices=jax.devices()[:n])
        _, jz = jax_make_sharded_query(jeng.plan, jmesh)(
            jeng._pots, [jnp.asarray(m) for m in masks])
        np.testing.assert_allclose(outs[n], np.asarray(jz), rtol=1e-9)
    for n in (2, 4, 8):
        np.testing.assert_allclose(outs[n], outs[1], rtol=1e-12)


def test_two_process_distributed_psum():
    """Two OS processes join through ``multihost.initialize`` (gloo), each
    serves its half of the rows, and both print the same global mean logZ:
    that of one process's engine over the whole batch, and the JAX
    package's."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    worker = os.path.join(os.path.dirname(__file__), "_torch_multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)

    gsums = [float(next(l for l in out.splitlines()
                        if l.startswith("GSUM ")).split()[1]) for out in outs]
    rows = [next(l for l in out.splitlines() if l.startswith("ROWS "))
            for out in outs]
    assert gsums[0] == gsums[1]
    assert rows == ["ROWS 0 8", "ROWS 4 8"]

    factors, sizes, values = grid_mrf_model(3, 3, seed=0)
    plan = jt.compile_plan(factors, sizes)
    eng = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)
    evs = jt.random_evidence_batch(plan, 8, list(sizes)[:3], seed=1)
    _, z = eng.query_batch(jt.batch_masks(plan, evs))
    assert gsums[0] == pytest.approx(float(np.log(z.numpy()).mean()), rel=1e-10)
    jeng = jt_jax.create_junction_tree(factors, sizes).engine() \
        .set_potentials(values)
    _, jz = jeng.query_batch_vmap(
        [jnp.asarray(m) for m in jt.batch_masks(plan, evs)])
    assert gsums[0] == pytest.approx(float(np.mean(np.log(np.asarray(jz)))),
                                     rel=1e-9)
