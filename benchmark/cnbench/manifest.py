"""BENCHMARK.json and the files it names, each found by name:

  benchmark/configs/<config>.json    the model as it is run, its source,
                                     what was assumed and reduced, recipe;
  benchmark/traffic/<traffic>.json   a mix: its kind (the generator and
                                     window in cnbench/kinds/<kind>.py)
                                     and its parameters;
  benchmark/limits/<workload>.json   the limit of each number the
                                     comparison with the reference reads;
  benchmark/metrics/<metric>.py      a reader of one per-layer metric:
                                     read(records) -> float or None.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str, bench: Optional[Dict] = None) -> Dict:
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> Dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> Dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(workload_name: str) -> Dict[str, float]:
    return load_json(BENCH_DIR / "limits" / f"{workload_name}.json")["limits"]


def metrics_for(workload_name: str, section: str, bench: Optional[Dict] = None) -> List[Dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the
    workload reports: those that list it, and those that list none."""
    bench = bench or manifest()
    return [m for m in bench[section]
            if workload_name in m.get("workloads", [workload_name])]


def metric_reader(name: str) -> Callable:
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cnbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
