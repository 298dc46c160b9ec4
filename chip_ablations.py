#!/usr/bin/env python3
"""The ablation suites on one card, with each run's wall time.

    python3 chip_ablations.py [--suite v1|v2|both] [--deadline 2700]

Runs `python -m centernet_lightning_torch.cli.run_ablations --arm A
--seed S` for every arm of the suite and seeds 0 and 1, one process each
(what `--all` runs), then `cli.validate` on giou_cs s0's final and best
checkpoints in float and with `--quantize 3`, then, with `--suite both`,
the v2 arms while the deadline leaves room for one (estimated at 2.5x the
slowest v1 arm until a v2 arm has run). Run directories (with their
checkpoints) go under `--work`; each arm's result file, metrics.jsonl and
log, the validations' logs and `walls.json` (the card's name and power
limit, each run's exit code and wall seconds) under `--results`. Prints
the suite's `--report` table and the validations' metrics last.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

V1 = ["l1", "giou", "giou_cs", "ttfnet", "dcn", "dcn_fast", "weighted_fpn",
      "bifpn", "ida"]
V2 = ["v2_fpn", "v2_weighted", "v2_bifpn", "v2_ida"]
TOOL = [sys.executable, "-m", "centernet_lightning_torch.cli.run_ablations"]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--suite", choices=("v1", "v2", "both"), default="both")
    p.add_argument("--deadline", type=float, default=2700.0,
                   help="seconds after which no v2 arm starts")
    p.add_argument("--work", default="runs/abl_work")
    p.add_argument("--results", default="runs/ablations")
    args = p.parse_args()
    t0 = time.time()
    os.makedirs(args.work, exist_ok=True)
    os.makedirs(args.results, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print("card:", card, flush=True)
    walls = {}

    def save():
        with open(os.path.join(args.results, "walls.json"), "w") as f:
            json.dump({"card": card, "walls": walls}, f, indent=1)

    def run(name, cmd):
        t = time.time()
        with open(os.path.join(args.results, f"{name}.log"), "w") as f:
            rc = subprocess.call(cmd, stdout=f, stderr=subprocess.STDOUT)
        walls[name] = {"rc": rc, "wall_s": round(time.time() - t, 1)}
        print(name, rc, walls[name]["wall_s"], flush=True)
        save()

    def arm(name, seed):
        run(f"{name}_s{seed}", TOOL + ["--out", args.work, "--arm", name,
                                       "--seed", str(seed)])
        result = os.path.join(args.work, f"{name}_s{seed}.json")
        if os.path.exists(result):
            shutil.copy(result, args.results)
        log = os.path.join(args.work, f"{name}_s{seed}", "logs",
                           "metrics.jsonl")
        if os.path.exists(log):
            shutil.copy(log, os.path.join(args.results,
                                          f"{name}_s{seed}.metrics.jsonl"))

    if args.suite in ("v1", "both"):
        for name in V1:
            for seed in (0, 1):
                arm(name, seed)
        root = os.path.join(args.work, "shapes")
        for tag, ckpt in (("final", "giou_cs_s0/checkpoints"),
                          ("best", "giou_cs_s0/checkpoints/best")):
            for q in (0, 3):
                run(f"validate_{tag}_q{q}", [
                    sys.executable, "-m", "centernet_lightning_torch.cli.validate",
                    "--checkpoint", os.path.join(args.work, ckpt),
                    "--img-dir", os.path.join(root, "images"),
                    "--ann-json", os.path.join(root, "val.json"),
                    "--image-size", "128", "--batch-size", "16",
                    "--quantize", str(q)])
    if args.suite in ("v2", "both"):
        v1_walls = [w["wall_s"] for k, w in walls.items()
                    if not k.startswith(("validate", "v2_"))]
        estimate = 2.5 * max(v1_walls) if v1_walls else 0.0
        for seed in (0, 1):
            for name in V2:
                left = args.deadline - (time.time() - t0)
                if left < 1.2 * estimate:
                    walls[f"{name}_s{seed}"] = {"skipped": True,
                                                "left_s": round(left),
                                                "estimate_s": round(estimate)}
                    print("skip", name, seed, round(left), round(estimate),
                          flush=True)
                    save()
                    continue
                arm(name, seed)
                v2_walls = [w["wall_s"] for k, w in walls.items()
                            if k.startswith("v2_") and "wall_s" in w]
                estimate = max(v2_walls)
    subprocess.call(TOOL + ["--out", args.work, "--report"])
    for name in sorted(walls):
        if name.startswith("validate_"):
            with open(os.path.join(args.results, f"{name}.log")) as f:
                print(name, f.read()[-600:])
    print("total_s", round(time.time() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
