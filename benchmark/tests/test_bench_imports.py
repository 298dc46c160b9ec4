"""Nothing the benchmark runs imports JAX, the JAX package or the root
scripts: every import of every module under benchmark/, compared by its
top-level name (the part before the first dot) whole, and the modules a
harness process holds once it has loaded the port."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "centernet_lightning_tpu", "chip_smoke",
             "bench_torch", "bench", "bench_suite", "bench_train", "bench_track",
             "bench_eval", "chip_ab", "chip_ablations", "tests"}


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_a_forbidden_name():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(BENCH)): sorted(set(imported_top_levels(f)) & FORBIDDEN)
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_the_port_name_is_not_the_jax_package():
    # the port's name begins with the JAX package's; compared whole, it differs
    assert "centernet_lightning_torch".split(".")[0] not in FORBIDDEN


def test_harness_process_loads_no_forbidden_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, control\n"
        "from cnbench import runner, manifest, judge, trace, traffic, weights, readers\n"
        "from cnbench.kinds import offline, train\n"
        "import reference.model, reference.train, roofline.flops\n"
        "import centernet_lightning_torch.api, centernet_lightning_torch.train\n"
        "print(run.forbidden_loaded())\n" % (str(BENCH), str(BENCH.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
