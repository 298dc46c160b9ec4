"""COCO validation of a checkpoint (port of tools/validate.py): the 12
COCO metrics as one JSON line.

    python -m centernet_lightning_torch.cli.validate \
        --checkpoint runs/coco/checkpoints \
        --img-dir .../val2017 --ann-json .../instances_val2017.json

A DCN model's offsets are audited on the first batch first (stderr), so
a clamped engine cannot cost accuracy unseen. `--quantize N` serves the
model in int8, calibrated on the loader's first N batches. Reading the
images needs OpenCV.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="COCO validation of a "
                                                 "checkpoint")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--img-dir", required=True)
    parser.add_argument("--ann-json", required=True)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--image-size", type=int, default=512)
    parser.add_argument("--num-detections", type=int, default=100)
    parser.add_argument("--save-results", default=None,
                        help="also write a COCO results-format json of the "
                             "predictions")
    parser.add_argument("--quantize", type=int, default=0, metavar="N",
                        help="serve int8, calibrated on the first N batches")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    import numpy as np

    from ..api import build_centernet
    from ..data import CocoDetection, build_dataloader, build_transforms
    from ..eval.coco_eval import CocoEvaluator
    from ..utils.box_np import convert_box_format
    from ..utils.dcn_audit import (audit_dcn_offsets, dcn_engine_displacement,
                                   format_dcn_audit, model_uses_dcn)

    predictor = build_centernet(
        args.config or args.checkpoint,
        checkpoint=args.checkpoint if args.config else None,
        device=args.device,
    )
    tf = build_transforms([
        {"name": "Resize", "init_args": {"height": args.image_size,
                                         "width": args.image_size}},
        {"name": "Normalize", "init_args": {"mean": list(predictor.mean),
                                            "std": list(predictor.std)}},
    ])
    ds = CocoDetection(args.img_dir, args.ann_json, transforms=tf)
    loader = build_dataloader(ds, batch_size=args.batch_size, shuffle=False,
                              num_workers=4, max_boxes=128, drop_last=False)

    if model_uses_dcn(predictor.task):
        calib_batch = next(iter(loader))
        stats = audit_dcn_offsets(predictor.task,
                                  predictor.prepare_images(calib_batch["image"]))
        print(format_dcn_audit(stats, dcn_engine_displacement(predictor.task)),
              file=sys.stderr)

    if args.quantize > 0:
        calib = []
        for batch in loader:
            calib.append(batch["image"])
            if len(calib) >= args.quantize:
                break
        predictor = predictor.quantize(calib)
        print(f"int8 serving: calibrated on {len(calib)} batches",
              file=sys.stderr)

    evaluator = CocoEvaluator(predictor.task.num_classes)
    all_image_ids = []
    for batch in loader:
        dets = predictor.gather_detection2d(
            batch["image"], num_detections=args.num_detections)
        n = batch["image"].shape[0]
        boxes_xywh = convert_box_format(dets["bboxes"], "xyxy", "xywh")
        preds = [{"boxes": boxes_xywh[i], "scores": dets["scores"][i],
                  "labels": dets["labels"][i]} for i in range(n)]
        targets = []
        for i in range(n):
            m = batch["mask"][i].astype(bool)
            entry = {"boxes": batch["boxes"][i][m],
                     "labels": batch["labels"][i][m]}
            for key in ("iscrowd", "area"):
                if key in batch:
                    entry[key] = batch[key][i][m]
            targets.append(entry)
        evaluator.update(preds, targets)
        if "image_id" in batch:
            ids = np.asarray(batch["image_id"]).reshape(-1)[:n]
        else:  # globally increasing fallback
            ids = np.arange(len(all_image_ids), len(all_image_ids) + n)
        all_image_ids.extend(ids.tolist())

    if args.save_results:
        from ..eval.utils import detections_to_coco_results

        detections_to_coco_results(all_image_ids, evaluator.preds,
                                   save_path=args.save_results)
        print(f"wrote COCO results json -> {args.save_results}",
              file=sys.stderr)

    metrics = evaluator.get_metrics()
    print(json.dumps({k: round(float(v), 4) for k, v in metrics.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
