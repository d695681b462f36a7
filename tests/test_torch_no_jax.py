"""``junctiontree_tpu_torch`` imports and serves without JAX: in a fresh
interpreter where ``import jax`` fails, run sprinkler end to end."""

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
eng = tree.engine().set_potentials(values)
rain = tree.plan.table.id_of("rain")
post, p_wet = eng.query({"wet_grass": 1})
batch, logz = eng.posterior_batch(jt.batch_masks_sparse(tree.plan, [{"wet_grass": 1}]))
assert round(float(post[rain][1]), 4) == 0.7079
assert round(float(batch[rain][0, 1]), 4) == 0.7079
assert abs(float(logz[0]) - __import__("math").log(p_wet)) < 1e-6
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
