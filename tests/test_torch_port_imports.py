"""The port and chip_smoke.py import nothing of JAX or the JAX package:
the machine with the card has no jax, and the port must not need it."""
import ast
import os

import pytest

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


SERVING_MODULES = ["quantize.py", "cli/serve.py", "cli/export.py",
                   "cli/convert_checkpoint.py"]


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_import_no_jax(module):
    """The int8 and deployment modules are among the files checked above
    and import nothing of JAX or the JAX package."""
    path = os.path.join(ROOT, "centernet_lightning_torch", *module.split("/"))
    assert os.path.normpath(path) in {os.path.normpath(f) for f in _python_files()}
    assert not set(_imported_roots(path)) & FORBIDDEN


PARALLEL_MODULES = ["parallel/__init__.py", "parallel/dist.py",
                    "cli/run_ablations.py", "data/shapes.py"]


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_and_ablation_modules_import_no_jax(module):
    """The data-parallel modules, the ablation tool and its shapes sets are
    among the files checked above and import nothing of JAX, the JAX
    package or tools/."""
    path = os.path.join(ROOT, "centernet_lightning_torch", *module.split("/"))
    assert os.path.normpath(path) in {os.path.normpath(f) for f in _python_files()}
    assert not set(_imported_roots(path)) & (FORBIDDEN | {"tools"})


def test_port_loads_without_opencv():
    """The card's machine has no OpenCV: the package, its data, eval and
    train subpackages and the trainer must import with cv2 hidden."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['cv2'] = None\n"
            "import centernet_lightning_torch, centernet_lightning_torch.data, "
            "centernet_lightning_torch.eval, centernet_lightning_torch.train\n"
            "from centernet_lightning_torch.train.trainer import Trainer\n"
            "from centernet_lightning_torch.data import transforms, mosaic\n"
            "from centernet_lightning_torch import quantize\n"
            "from centernet_lightning_torch.cli import serve, export, "
            "convert_checkpoint, run_ablations\n"
            "from centernet_lightning_torch import parallel\n"
            "from centernet_lightning_torch.data import shapes\n"
            "assert sys.modules['cv2'] is None\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
