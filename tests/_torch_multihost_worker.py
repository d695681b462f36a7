"""Worker process of the two-process ``torch.distributed`` test of the port
(``tests/test_torch_multihost.py``).  Imports no JAX.

Usage: python _torch_multihost_worker.py <process_id> <num_processes> <port>

Each process joins the group through ``multihost.initialize`` (gloo),
builds the (batch, model) mesh over four CPU devices of its own with
``make_multihost_mesh``, places its half of a seeded evidence batch with
``host_local_batch_to_global``, and serves it through
``make_sharded_query_shardmap``, whose global mean logZ is an all_reduce
over both processes.  Prints ``GSUM <value>``, ``ROWS <offset> <total>``."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.modules["jax"] = None  # the port must not need JAX

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import junctiontree_tpu_torch as jt  # noqa: E402
from junctiontree_tpu_torch.models import grid_mrf_model  # noqa: E402
from junctiontree_tpu_torch.parallel import multihost  # noqa: E402
from junctiontree_tpu_torch.parallel.batch import (  # noqa: E402
    make_sharded_query_shardmap,
)

multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=pid, backend="gloo")
assert torch.distributed.get_world_size() == nproc

factors, sizes, values = grid_mrf_model(3, 3, seed=0)
plan = jt.compile_plan(factors, sizes)
eng = jt.Engine(plan, device="cpu", dtype=torch.float64).set_potentials(values)

B = 8
evs = jt.random_evidence_batch(plan, B, list(sizes)[:3], seed=1)
full = jt.batch_masks(plan, evs)

mesh = multihost.make_multihost_mesh(n_model_per_host=1, devices=["cpu"] * 4)
assert mesh.shape == {"batch": 4 * nproc, "model": 1}, mesh.shape

per = B // nproc
local = multihost.host_local_batch_to_global(
    mesh, [m[pid * per:(pid + 1) * per] for m in full])
assert local.offset == pid * per and local.total == B

fn = make_sharded_query_shardmap(plan, mesh)
_, z, mean_logz = fn(eng._pots, local.arrays)
assert z.shape == (per,)
print(f"GSUM {float(mean_logz):.12f}", flush=True)
print(f"ROWS {local.offset} {local.total}", flush=True)
torch.distributed.destroy_process_group()
