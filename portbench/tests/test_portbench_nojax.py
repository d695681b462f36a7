"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import os

from portbench import core

REFERENCE = {"reference.py", "roofline.py", "evidence.py"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _modules():
    for dirpath, dirs, files in os.walk(core.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = []
    for path in _modules():
        for name in _imports(path):
            if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                      "junctiontree_tpu"):
                found.append((path, name))
    assert found == []
    assert len(list(_modules())) > 10


def test_the_port_name_is_not_taken_for_the_jax_package():
    # the top-level name is compared whole: the port's begins with JAX's
    assert "junctiontree_tpu_torch".split(".")[0] not in core.FORBIDDEN
    assert "junctiontree_tpu.ops".split(".")[0] in core.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in _modules():
        if os.path.basename(path) in REFERENCE or os.path.basename(
                os.path.dirname(path)) == "models":
            for name in _imports(path):
                assert name.split(".")[0] != "junctiontree_tpu_torch", (
                    path, name)
