"""``junctiontree_tpu_torch`` imports and serves without JAX: in a fresh
interpreter where ``import jax`` fails, run sprinkler end to end through
every query surface."""

import os
import subprocess
import sys

_PROBE = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import junctiontree_tpu_torch as jt
from junctiontree_tpu_torch.models import sprinkler_model

factors, sizes, values = sprinkler_model()
tree = jt.create_junction_tree(factors, sizes)
eng = tree.engine(device="cpu").set_potentials(values)
rain = tree.plan.table.id_of("rain")
post, p_wet = eng.query({"wet_grass": 1})
batch, logz = eng.posterior_batch(jt.batch_masks_sparse(tree.plan, [{"wet_grass": 1}]))
assert round(float(post[rain][1]), 4) == 0.7079
assert round(float(batch[rain][0, 1]), 4) == 0.7079
assert abs(float(logz[0]) - __import__("math").log(p_wet)) < 1e-6
# every module of the package imports, and the log, chain and fused paths serve
import importlib, pkgutil
for info in pkgutil.walk_packages(jt.__path__, jt.__name__ + "."):
    importlib.import_module(info.name)
log_eng = tree.engine("log_sum_exp", device="cpu").set_potentials(values)
lpost, _ = log_eng.posterior_batch(
    jt.batch_masks_sparse(tree.plan, [{"wet_grass": 1}], jt.LOG_SUM_EXP))
assert round(float(lpost[rain][0, 1]), 4) == 0.7079
fpost, _ = eng.posterior_batch(
    jt.batch_masks_sparse(tree.plan, [{"wet_grass": 1}]), mode="fused", chunk=4)
assert round(float(fpost[rain][0, 1]), 4) == 0.7079
from junctiontree_tpu_torch.models import chain_bn_model
cf, cs, cv = chain_bn_model(6, seed=0)
ceng = jt.create_junction_tree(cf, cs).engine(device="cpu").set_potentials(cv)
assert ceng._route("auto") == "chain"
_, clogz = ceng.posterior_batch({})
assert abs(float(clogz[0])) < 1e-5
# the query surfaces beyond posteriors, and tree surgery
import os, tempfile
import numpy as np
import junctiontree_tpu_torch.surgery as surgery
assign, score = eng.map_assignment({"wet_grass": 1})
assert assign["wet_grass"] == 1 and abs(eng.score_assignment(assign) - score) < 1e-5
top = eng.top_k_assignments({"wet_grass": 1}, k=3)
assert len(top) == 3 and abs(top[0][1] - score) < 1e-5
assert top[0][1] >= top[1][1] >= top[2][1]
h, pz = eng.entropy({"wet_grass": 1})
assert h > 0 and abs(pz - p_wet) < 1e-6
joint, _ = eng.joint_marginal(["rain", "sprinkler"], {"wet_grass": 1})
assert abs(float(joint.sum(axis=1)[1]) - 0.7079) < 1e-4
assert eng.mutual_information("rain", "sprinkler") > 0
wet = np.array([[0.0, 1.0]], dtype=np.float32)
sess = eng.incremental({"wet_grass": np.ones((1, 2), dtype=np.float32)})
dposts, dlogz = sess.query({"wet_grass": wet}, ["rain"])
assert round(float(dposts[0][0, 1]), 4) == 0.7079
assert abs(float(dlogz[0]) - float(logz[0])) < 1e-6
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "engine.npz")
    eng.save(path)
    back = jt.Engine.load(path, device="cpu")
assert round(float(back.query({"wet_grass": 1})[0][rain][1]), 4) == 0.7079
back.multiply_factor(["rain"], np.array([1.0, 0.0]))
assert float(back.query({})[0][rain][1]) == 0.0
plan2, covered = surgery.add_factor(tree.plan, ["rain"])
assert covered and jt.add_factor is surgery.add_factor
assert "kernel_launches" in eng.describe()
assert not any(m.startswith("junctiontree_tpu.") or m == "junctiontree_tpu"
               for m in sys.modules)
print("ok")
"""


def test_imports_and_serves_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, cwd=root, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
