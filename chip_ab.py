"""Compare the host-bound phases of chip_smoke.py between two source trees
on one card: tracking (`tracking_phases`), validation (`validation_phases`)
and the train CLI (`cli_phases`), each run in a fresh process from its
tree's own chip_smoke.py and package, in a seeded random order of RUNS runs
a tree, so that drift of the host over the call falls on both trees alike.

    python chip_ab.py --tree parent=ab_trees/parent --tree change=. \\
        [--runs 4] [--seed 0] [--logs DIR]

Prints one JSON line a run (tree, order, the phases' figures) and, as its
last line, each figure's runs per tree; `--logs` keeps each run's whole
output. Needs a CUDA card; each tree builds its own kernels on its first
run.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys

# run inside a tree: build its kernels, then the three phases, printing
# chip_smoke's own JSON lines
CHILD = r"""
import sys
sys.path.insert(0, ".")
import chip_smoke as c
from centernet_lightning_torch.ops import _build, dcn_fused, dcn_sample, peak_decode, pool
_build.build_all()
kernels = [peak_decode.peak_class_scores_cuda, dcn_sample.dcn_sample_taps,
           dcn_fused.dcn_fused_conv, pool.max_pool_3x3_s2_auto]
def reset():
    for k in kernels:
        k.launches = 0
def read():
    return {k.__name__: k.launches for k in kernels}
card = c.card_line()
c.tracking_phases(card, reset, read)
c.validation_phases(card, reset, read)
c.cli_phases(card, reset, read)
"""

# (phase, key path) of each figure compared
FIGURES = {
    "tracking_frames_per_s_d1": ("tracking_times", ("frames_per_s", "1")),
    "tracking_frames_per_s_d2": ("tracking_times", ("frames_per_s", "2")),
    "tracking_association_ms": ("tracking_times", ("association_ms_per_frame",)),
    "tracking_dispatch_ms": ("tracking_times", ("dispatch_host_ms_per_batch",)),
    "validation_images_per_s": ("validation_main_path", ("val_images_per_s",)),
    "tracking_validation_frames_per_s": ("tracking_validation", ("frames_per_s",)),
    "cli_train_images_per_s": ("cli_main_path", ("train_images_per_s",)),
    "cli_loader_ms": ("cli_main_path", ("loader_ms_per_batch",)),
}


def figures(lines):
    phases = {}
    for line in lines:
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            phases.setdefault(obj.get("phase"), obj)
    out = {}
    for name, (phase, path) in FIGURES.items():
        v = phases.get(phase)
        for key in path:
            v = v.get(key) if isinstance(v, dict) else None
        out[name] = v
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", required=True,
                        help="NAME=DIR, a tree holding chip_smoke.py (twice)")
    parser.add_argument("--runs", type=int, default=4, help="runs a tree")
    parser.add_argument("--seed", type=int, default=0, help="order's seed")
    parser.add_argument("--logs", help="folder for each run's whole output")
    args = parser.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    order = [name for name in trees for _ in range(args.runs)]
    random.Random(args.seed).shuffle(order)
    if args.logs:
        os.makedirs(args.logs, exist_ok=True)
    per_tree = {name: {f: [] for f in FIGURES} for name in trees}
    failed = 0
    for i, name in enumerate(order):
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=trees[name],
                              capture_output=True, text=True)
        if args.logs:
            with open(os.path.join(args.logs, f"{i}_{name}.log"), "w") as f:
                f.write(proc.stdout + "\n---- stderr ----\n" + proc.stderr)
        figs = figures(proc.stdout.splitlines())
        for f, v in figs.items():
            per_tree[name][f].append(v)
        failed += proc.returncode != 0
        print(json.dumps({"run": i, "tree": name, "rc": proc.returncode, **figs}),
              flush=True)
    print(json.dumps({"order": order, "figures": per_tree}))
    return int(failed > 0)


if __name__ == "__main__":
    raise SystemExit(main())
