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
# learning, sampling, structure, and the solvers beside the engine
import torch
from junctiontree_tpu_torch import learn, learn_chain, sampling
samples = sampling.engine_sample(eng, 0, 400)
assert samples.shape == (400, 4)
thetas, hist = learn.fit_mle(tree.plan, samples, steps=3, device="cpu")
assert hist[-1] > hist[0]
holes = samples.copy()
holes[::3, rain] = -1
_, hist = learn.fit_mle_missing(tree.plan, holes, steps=3, device="cpu")
assert hist[-1] > hist[0]
counts = learn.expected_counts(
    tree.plan, values, learn.masks_from_data(tree.plan, holes), device="cpu")
assert all(abs(c.sum() - 400) < 1e-2 for c in counts)
_, hist = learn.fit_em(tree.plan, holes, steps=2, device="cpu")
assert len(hist) == 2
cdata = sampling.engine_sample(ceng, 1, 50)
_, hist = learn_chain.fit_mle_chain(ceng.plan, cdata, steps=3, device="cpu")
assert hist[-1] > hist[0]
f2, s2, v2, edges = jt.chow_liu(samples, labels=[tree.plan.table.label_of(i) for i in range(4)], device="cpu")
assert len(edges) == 3
assign, _ = jt.marginal_map(factors, values, sizes, ["rain"], {"wet_grass": 1}, device="cpu")
assert assign == {"rain": 1}
assert tree.marginal_map(values, ["rain"], {"wet_grass": 1}, device="cpu")[0] == assign
cut = jt.CutsetEngine(factors, sizes, values, cutset=["rain"], device="cpu")
cposts, clz = cut.posterior_batch({"wet_grass": wet})
assert round(float(cposts["rain"][0, 1]), 4) == 0.7079
assert abs(float(clz[0]) - float(logz[0])) < 1e-5
assert cut.map_assignment({"wet_grass": 1})[0]["wet_grass"] == 1
loopy = jt.LoopyEngine(factors, sizes, values, device="cpu")
lposts, _, info = loopy.posterior({"wet_grass": 1})
lrain = lposts[loopy.table.id_of("rain")]
assert abs(float(lrain.sum()) - 1) < 1e-5 and float(lrain[1]) > 0.5  # approximate
from junctiontree_tpu_torch.utils import bif, uai
assert uai.parse_uai(uai.write_uai([[0, 1]], {0: 2, 1: 2}, [np.ones((2, 2))]))[0] == [[0, 1]]
# the CLI, the compatibility shims and Config, the native compiler, routing
import contextlib, io
from junctiontree_tpu_torch import __main__ as cli, computation, construction, native
from junctiontree_tpu_torch.ops import autotune
from junctiontree_tpu_torch.sum_product import SumProduct
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "m.uai")
    with open(path, "w") as f:
        f.write(uai.write_uai([[0, 1]], {0: 2, 1: 2}, [np.array([[1.0, 2.0], [3.0, 4.0]])]))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([path, "--task", "PR", "--device", "cpu"]) == 0
assert abs(float(buf.getvalue().split()[1]) - 1.0) < 1e-6
ceng2 = jt.Config(semiring="log_sum_exp").engine(factors, sizes, values, device="cpu")
assert round(float(ceng2.posterior_batch(jt.batch_masks_sparse(
    tree.plan, [{"wet_grass": 1}], jt.LOG_SUM_EXP))[0][rain][0, 1]), 4) == 0.7079
assert jt.api.einsum([np.ones((2, 3))], [["a", "b"]], ["a"], device="cpu").tolist() == [3.0, 3.0]
assert SumProduct(device="cpu").einsum(np.ones(2), ["a"], []) == 2.0
cb, sb = computation.compute_beliefs(tree.plan, eng._pots_np, device="cpu")
assert len(cb) == tree.plan.tri.num_cliques
assert construction.find_subtree(tree.tree, 0)
assert native.available()
big_chain = chain_bn_model(600, seed=0)
assert jt.compile_plan(*big_chain[:2]).tri.num_cliques == 599
margs, z = eng.query_batch_vmap(jt.batch_masks(tree.plan, [{"wet_grass": 1}]))
assert abs(float(z[0]) - p_wet) < 1e-6
assert isinstance(autotune.report(), dict)
assert jt.apply_evidence([np.ones((2, 2))], [["rain", "wet_grass"]], {"rain": 1})[0].shape == (1, 2)
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


def test_no_module_of_the_port_names_jax():
    """No source file of the package, nor ``chip_smoke.py``, imports ``jax``
    or the JAX package (the modules of learning and the solvers, the CLI,
    the compatibility shims, the native compiler and measured routing
    included)."""
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "junctiontree_tpu_torch")
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    rel = {os.path.relpath(f, pkg) for f in files}
    for mod in ("learn.py", "learn_chain.py", "sampling.py", "structure.py",
                "mmap.py", "cutset.py", "approx.py", "utils/uai.py",
                "utils/bif.py", "__main__.py", "native/__init__.py",
                "construction.py", "computation.py", "sum_product.py",
                "ops/autotune.py", "config.py"):
        assert mod in rel, mod
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|optax|junctiontree_tpu)(\.|\s|$)", re.M)
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
