"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with the cards
the cell asks for. --trace 0 prints the cell's end-to-end metrics, --trace
1 its per-layer metrics from a profiled slice of the window. The last line
of standard output is one JSON object; the numbers compared with the
reference, each beside its limit, are the last lines of standard error
and the result's last key.
"""
import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "centernet_lightning_tpu"}
CACHE = ROOT / ".bench_cache"


def forbidden_loaded():
    return sorted(FORBIDDEN & {name.split(".")[0] for name in list(sys.modules)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path[:0] = [str(BENCH), str(ROOT)]

    from cnbench import manifest, runner
    from cnbench.common import Cell, power_limit
    import torch

    bench = manifest.manifest()
    wl = manifest.workload(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import centernet_lightning_torch
    if ROOT not in Path(centernet_lightning_torch.__file__).resolve().parents:
        print(f"centernet_lightning_torch loads from "
              f"{centernet_lightning_torch.__file__}, outside {ROOT}", file=sys.stderr)
        return 2

    cell = Cell(name=wl["name"], config=manifest.config(wl["config"]),
                traffic=manifest.traffic(wl["traffic"]),
                limits=manifest.limits(wl["name"]), seed=args.seed % 2 ** 63,
                seconds=args.seconds, trace=bool(args.trace),
                device=torch.device("cuda"), started=_STARTED)
    result, checks = runner.run(cell, bench)

    found = forbidden_loaded()
    if found:
        print(f"modules that must not load did: {found}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    print(json.dumps(result))                   # "checks" is its last key
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
