"""Training-recipe ablations on the synthetic shapes sets (port of
tools/run_ablations.py, with the same arms, suites, base recipe and
dataset seed).

The reference's experiment ledger orders its recipes; a faithful port of
the losses, target rendering, centre sampling and optimiser should keep
that order on any non-trivial dataset. Reference anchors (COCO / VOC mAP,
`REF`): L1 w0.1 18.6 against GIoU w5 with 3x3 centre sampling 32.7-37.3;
the cornernet and ttfnet radii about equal (37.3 / 37.2); FPN 25.8 against
FPN with DCNv2 37.5. Expected on the shapes set:
l1 << giou <= giou_cs, |ttfnet - giou_cs| small, dcn >= giou_cs.

Every arm is ResNet-18 + FPN-64 (heads 64 x 2) at 128^2 (v2: 256^2,
20 classes), AdamW 5e-4 * 16 / 128 with 5 warm-up epochs then cosine,
batch 16, 40 epochs (v2: 110), bf16 on the card, `box_log` with
`box_multiplier` 4 on every arm (the decode is held constant, so the
ablated deltas stay the reference's). One arm and seed a process:

    python -m centernet_lightning_torch.cli.run_ablations --out runs/abl --all
    python -m centernet_lightning_torch.cli.run_ablations --out runs/abl \\
        --arm giou_cs --seed 0
    python -m centernet_lightning_torch.cli.run_ablations --out runs/abl --report

An arm resumes from its own run directory. A preempted fit (SIGTERM)
checkpoints and writes no result file, so `--all` runs it again.
CENTERNET_TPU_SMOKE_DATASET=1 shrinks the dataset to 24 images (the name
is shared with the JAX package's tool). Reading the images needs OpenCV.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

__all__ = ["ARMS", "SUITES", "REF", "DATASET_SEED", "ensure_dataset",
           "arm_setup", "run_arm", "report", "main"]

# knob deltas per arm, applied over the shared base recipe
_GIOU_CS = {"box_loss": "GIoULoss", "box_loss_weight": 5.0,
            "center_sampling_size": 3}
ARMS = {
    "l1": {"box_loss": "L1Loss", "box_loss_weight": 0.1,
           "center_sampling_size": 1},
    "giou": {"box_loss": "GIoULoss", "box_loss_weight": 5.0,
             "center_sampling_size": 1},
    "giou_cs": dict(_GIOU_CS),
    "ttfnet": dict(_GIOU_CS, heatmap_target="ttfnet"),
    "dcn": dict(_GIOU_CS, neck_config={"out_channels": 64,
                                       "conv_type": "dcn"}),
    # the bounded engine: exact while the trained offsets stay within
    # +-2, which the result's offset audit records
    "dcn_fast": dict(_GIOU_CS, neck_config={"out_channels": 64,
                                            "conv_type": "dcn_fast_d2"}),
    # the neck family (reference VOC table: FPN 25.8 < weighted 26.3 <
    # IDA 27.6 < BiFPN 32.1 < FPN + DCNv2 37.5; giou_cs is the FPN arm)
    "weighted_fpn": dict(_GIOU_CS, neck_config={"out_channels": 64,
                                                "weighted": True}),
    "bifpn": dict(_GIOU_CS, neck="BiFPN", neck_config={"out_channels": 64}),
    "ida": dict(_GIOU_CS, neck="IDA", neck_config={"out_channels": 64}),
    # v2: the neck family again on the multi-scale 20-class 256^2 set,
    # where cross-scale fusion has something to find
    "v2_fpn": dict(_GIOU_CS),
    "v2_weighted": dict(_GIOU_CS, neck_config={"out_channels": 64,
                                               "weighted": True}),
    "v2_bifpn": dict(_GIOU_CS, neck="BiFPN", neck_config={"out_channels": 64}),
    "v2_ida": dict(_GIOU_CS, neck="IDA", neck_config={"out_channels": 64}),
}

SUITES = {
    "v1": [a for a in ARMS if not a.startswith("v2_")],
    "v2": [a for a in ARMS if a.startswith("v2_")],
}

# the reference's measured anchors for the report (COCO / VOC mAP)
REF = {"l1": 18.6, "giou": 34.6, "giou_cs": 37.3, "ttfnet": 37.2,
       "dcn": 37.5, "dcn_fast": 37.5, "weighted_fpn": 26.3, "bifpn": 32.1,
       "ida": 27.6, "v2_fpn": 25.8, "v2_weighted": 26.3, "v2_bifpn": 32.1,
       "v2_ida": 27.6}

DATASET_SEED = 7  # one fixed dataset for every arm

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def ensure_dataset(out: str, v2: bool = False) -> str:
    """The arms' shapes set under `out` (made once): v1 300 images of 2-6
    shapes at 128^2, v2 the multi-scale 20-class 256^2 set; 24 images
    with CENTERNET_TPU_SMOKE_DATASET set. A DATASET_SIZE marker refuses a
    set of the other size left in `out`."""
    root = os.path.join(out, "shapes_v2" if v2 else "shapes")
    n_images = 24 if os.environ.get("CENTERNET_TPU_SMOKE_DATASET") else 300
    marker = os.path.join(root, "DATASET_SIZE")
    if os.path.exists(os.path.join(root, "val.json")):
        if os.path.exists(marker):
            with open(marker) as f:
                existing = int(f.read().strip())
        else:  # a set without the marker: count it and stamp the marker
            existing = 0
            for split in ("train.json", "val.json"):
                with open(os.path.join(root, split)) as f:
                    existing += len(json.load(f)["images"])
            with open(marker, "w") as f:
                f.write(str(existing))
        if existing != n_images:
            raise SystemExit(
                f"{root} holds a {existing}-image shapes set but this run "
                f"needs {n_images} images; delete it (or use a different "
                f"--out) before re-running")
        return root
    from ..data.shapes import make_shapes_dataset, make_shapes_v2_dataset

    if v2:
        make_shapes_v2_dataset(root, n_images=n_images, val_fraction=0.2,
                               seed=DATASET_SEED)
    else:
        make_shapes_dataset(root, n_images=n_images, size=128, min_shapes=2,
                            max_shapes=6, val_fraction=0.2,
                            seed=DATASET_SEED)
    with open(marker, "w") as f:
        f.write(str(n_images))
    return root


def arm_setup(arm: str, seed: int, out: str, epochs: int, root: str,
              on_card: bool):
    """(task kwargs, train data, val data, Trainer kwargs) of one arm: the
    base recipe with the arm's deltas over it."""
    v2 = arm.startswith("v2_")
    img = 256 if v2 else 128
    train_data = {
        "type": "coco", "img_dir": os.path.join(root, "images"),
        "ann_json": os.path.join(root, "train.json"), "batch_size": 16,
        "transforms": [
            {"name": "HorizontalFlip"},
            {"name": "ColorJitter",
             "init_args": {"brightness": 0.3, "contrast": 0.3,
                           # v2 classes are hue-coded: hue or saturation
                           # jitter would relabel objects
                           "saturation": 0.0 if v2 else 0.3}},
            {"name": "Normalize"},
        ],
    }
    val_data = {
        "type": "coco", "img_dir": os.path.join(root, "images"),
        "ann_json": os.path.join(root, "val.json"), "batch_size": 16,
        "transforms": [{"name": "Resize",
                        "init_args": {"height": img, "width": img}},
                       {"name": "Normalize"}],
    }
    task_kwargs = dict(
        num_classes=20 if v2 else 3, backbone="resnet18", neck="FPN",
        neck_config={"out_channels": 64},
        head_config={"width": 64, "depth": 2},
        box_log=True, box_multiplier=4.0, heatmap_target="cornernet",
        num_detections=100 if v2 else 50, image_size=(img, img),
    )
    task_kwargs.update(ARMS[arm])
    workdir = os.path.join(out, f"{arm}_s{seed}")
    trainer_kwargs = dict(
        max_epochs=epochs,
        optimizer_config={"optimizer": "AdamW", "lr": 5e-4 * 16 / 128,
                          "weight_decay": 1e-3, "warmup_epochs": 5,
                          "lr_scheduler": {"name": "CosineAnnealingLR"}},
        ckpt_dir=os.path.join(workdir, "checkpoints"),
        log_dir=os.path.join(workdir, "logs"),
        image_size=(img, img),
        seed=seed,
        # resume from the arm's own run directory: a preempted attempt
        # continues where its checkpoint stopped
        resume=True,
        diagnostics=False,
        precision="bf16" if on_card else None,
        log_every=15,  # the steps of an epoch: one images/s line an epoch
    )
    return task_kwargs, train_data, val_data, trainer_kwargs


def run_arm(arm: str, seed: int, out: str, epochs: int,
            device: str = "cuda") -> dict:
    """Train one arm, validate it, and write `<out>/<arm>_s<seed>.json`
    ({arm, seed, epochs, final: val metrics, best_mAP, and for a DCN arm
    the offset audit}). Exits with 3, writing nothing, when the fit was
    preempted."""
    import numpy as np
    import torch

    from ..data.builder import loader_from_config
    from ..models.centernet import CenterNet
    from ..train.trainer import Trainer
    from ..utils.dcn_audit import (audit_dcn_offsets, dcn_engine_displacement,
                                   model_uses_dcn)

    root = ensure_dataset(out, v2=arm.startswith("v2_"))
    on_card = torch.device(device).type == "cuda"
    task_kwargs, train_data, val_data, trainer_kwargs = arm_setup(
        arm, seed, out, epochs, root, on_card)
    task = CenterNet(**task_kwargs)
    trainer = Trainer(
        task,
        train_loader=loader_from_config(train_data, train=True, seed=seed),
        val_loader=loader_from_config(val_data, train=False),
        device=device, **trainer_kwargs)
    trainer.fit()
    if trainer._stop_requested:
        # a partial fit must leave no result file, or --all skips the arm
        print(f"{arm} s{seed}: preempted mid-fit - no result written")
        sys.exit(3)
    metrics = trainer.validate()
    result = {
        "arm": arm, "seed": seed, "epochs": epochs,
        "final": {k: round(float(v), 4) for k, v in metrics.items()},
        "best_mAP": round(float(trainer.best_metric), 4),
    }
    if model_uses_dcn(task):
        # a bounded engine (dcn_fast_dD) is exact iff max|offset| <= D
        batch = next(iter(loader_from_config(val_data, train=False)))
        stats = audit_dcn_offsets(task,
                                  np.asarray(batch["image"], np.float32))
        d_bound = dcn_engine_displacement(task)
        max_off = float(stats["max_offset"])
        result["dcn_audit"] = {
            "max_abs_offset": round(max_off, 3),
            "engine_bound": d_bound,
            "exact_by_construction": (d_bound is None
                                      or max_off <= float(d_bound)),
        }
    with open(os.path.join(out, f"{arm}_s{seed}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


def run_arm_subprocess(arm: str, seed: int, out: str, epochs: int,
                       arm_timeout: float, device: str) -> bool:
    """One arm in a fresh process, SIGTERMed at `arm_timeout` (the Trainer
    then checkpoints and the arm writes no result) and tried once more,
    resuming. True when the arm's result file exists."""
    done = os.path.join(out, f"{arm}_s{seed}.json")
    for attempt in (1, 2):
        if os.path.exists(done):
            return True
        cmd = [sys.executable, "-m", "centernet_lightning_torch.cli.run_ablations",
               "--out", out, "--arm", arm, "--seed", str(seed),
               "--epochs", str(epochs), "--device", device]
        print(f"-> {' '.join(cmd)}  (attempt {attempt})", flush=True)
        proc = subprocess.Popen(cmd, cwd=_PACKAGE_PARENT)
        try:
            proc.wait(timeout=arm_timeout)
        except subprocess.TimeoutExpired:
            proc.terminate()  # SIGTERM: checkpoint and a clean exit
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        print(f"== {arm} s{seed} attempt {attempt}: exit {proc.returncode}",
              flush=True)
    return os.path.exists(done)


def report(out: str) -> None:
    """A markdown table of the result files in `out`, one row an arm."""
    rows = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(".json") and "_s" in name:
            with open(os.path.join(out, name)) as f:
                r = json.load(f)
            rows.setdefault(r["arm"], []).append(r)
    print("| arm | ref mAP | val/mAP (per seed) | val/AP50 (per seed) | best |")
    print("|---|---|---|---|---|")
    for arm in ARMS:
        if arm not in rows:
            continue
        runs = sorted(rows[arm], key=lambda r: r["seed"])
        per_seed = ", ".join(
            f"s{r['seed']}: {r['final'].get('val/mAP', float('nan')):.3f}"
            for r in runs)
        ap50 = ", ".join(
            f"s{r['seed']}: {r['final'].get('val/AP50', float('nan')):.3f}"
            for r in runs)
        best = max(r["best_mAP"] for r in rows[arm])
        print(f"| {arm} | {REF[arm]} | {per_seed} | {ap50} | {best:.3f} |")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--arm", choices=sorted(ARMS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=None,
                   help="default 40 (v1 arms) / 110 (v2 arms)")
    p.add_argument("--seeds", type=int, default=2,
                   help="seeds per arm (--all)")
    p.add_argument("--arm-timeout", type=float, default=850.0,
                   help="per-arm wall budget in seconds (--all): SIGTERM "
                        "and one resumed retry")
    p.add_argument("--all", action="store_true",
                   help="every arm x seed of --suite, one process each")
    p.add_argument("--suite", choices=sorted(SUITES), default="v1",
                   help="--all's arms: v1 the recipe grid (128^2, 3 "
                        "classes), v2 the neck retest (256^2, 20 classes)")
    p.add_argument("--report", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; bf16 there, f32 on "
                        "the CPU)")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.report:
        report(args.out)
    elif args.all:
        missing = []
        for arm in SUITES[args.suite]:
            for seed in range(args.seeds):
                if os.path.exists(
                        os.path.join(args.out, f"{arm}_s{seed}.json")):
                    print(f"skip {arm} s{seed} (exists)")
                    continue
                # the exact-engine dcn arm takes about twice a plain
                # arm's time, the v2 arms (4x the pixels) 2.5x
                budget = args.arm_timeout * (
                    2.0 if arm == "dcn"
                    else 2.5 if arm.startswith("v2_") else 1.0)
                epochs = args.epochs or (
                    110 if arm.startswith("v2_") else 40)
                if not run_arm_subprocess(arm, seed, args.out, epochs,
                                          budget, args.device):
                    missing.append(f"{arm}_s{seed}")
        report(args.out)
        if missing:
            print(f"INCOMPLETE after retries: {', '.join(missing)} - rerun "
                  "--all to resume (finished arms are skipped)")
            return 4
    elif args.arm:
        run_arm(args.arm, args.seed, args.out,
                args.epochs or (110 if args.arm.startswith("v2_") else 40),
                device=args.device)
    else:
        p.error("one of --arm / --all / --report is required")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
