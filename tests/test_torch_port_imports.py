"""The port and chip_smoke.py import nothing of JAX or the JAX package:
the machine with the card has no jax, and the port must not need it."""
import ast
import os

ROOT = os.path.join(os.path.dirname(__file__), "..")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "centernet_lightning_tpu"}


def _python_files():
    yield os.path.join(ROOT, "chip_smoke.py")
    for base, _, files in os.walk(os.path.join(ROOT, "centernet_lightning_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = list(_python_files())
    assert len(files) > 15
    bad = [(os.path.relpath(f, ROOT), mod) for f in files
           for mod in _imported_roots(f) if mod in FORBIDDEN]
    assert not bad, bad
