"""Detect over a folder of images (port of tools/detect.py): writes a COCO
results-format json (image ids = positions in the sorted file order) and,
with `--save-images`, annotated copies of the images.

    python -m centernet_lightning_torch.cli.detect \
        --checkpoint runs/coco/checkpoints --images photos/ \
        --out /tmp/dets --score-threshold 0.3 --save-images

`--quantize N` serves the model in int8, calibrated on the first N images.
Reading and writing the images needs OpenCV.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from . import read_class_names

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Detect over a folder of "
                                                 "images")
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint dir (or yaml config via --config)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--images", required=True, help="folder of images")
    parser.add_argument("--out", required=True, help="output folder")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--num-detections", type=int, default=100)
    parser.add_argument("--score-threshold", type=float, default=0.3)
    parser.add_argument("--save-images", action="store_true",
                        help="also write annotated copies of the images")
    parser.add_argument("--class-names", default=None,
                        help="optional json/txt file with one class name per "
                             "line (annotation labels)")
    parser.add_argument("--quantize", type=int, default=0, metavar="N",
                        help="serve int8, calibrated on the first N images")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    import numpy as np

    from ..api import build_centernet
    from ..eval.utils import detections_to_coco_results

    predictor = build_centernet(
        args.config or args.checkpoint,
        checkpoint=args.checkpoint if args.config else None,
        device=args.device,
    )
    if args.quantize > 0:
        from ..quantize import load_calibration_images

        calib = load_calibration_images(args.images, args.quantize,
                                        predictor.image_size)
        predictor = predictor.quantize(calib)
        print(f"int8 serving: calibrated on {len(calib)} images",
              file=sys.stderr)

    class_names = read_class_names(args.class_names)

    dets = predictor.inference_detection(
        args.images, batch_size=args.batch_size,
        num_detections=args.num_detections,
        score_threshold=args.score_threshold,
    )

    os.makedirs(args.out, exist_ok=True)
    # boxes xyxy in original-image pixels -> xywh (the results format)
    preds = []
    for i in range(len(dets["image_paths"])):
        keep = dets["labels"][i] >= 0
        boxes = dets["bboxes"][i][keep]
        xywh = np.concatenate([boxes[:, :2], boxes[:, 2:] - boxes[:, :2]], 1)
        preds.append({
            "boxes": xywh,
            "scores": dets["scores"][i][keep],
            "labels": dets["labels"][i][keep],
        })
    results_path = os.path.join(args.out, "detections.json")
    results = detections_to_coco_results(
        range(len(preds)), preds, save_path=results_path)
    with open(os.path.join(args.out, "image_paths.json"), "w") as f:
        json.dump(list(dets["image_paths"]), f, indent=1)

    if args.save_images:
        import cv2

        from ..utils.viz import draw_boxes

        images_dir = os.path.join(args.out, "images")
        os.makedirs(images_dir, exist_ok=True)
        for i, path in enumerate(dets["image_paths"]):
            img = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                               cv2.COLOR_BGR2RGB)
            keep = dets["labels"][i] >= 0
            annotated = draw_boxes(
                img, dets["bboxes"][i][keep], labels=dets["labels"][i][keep],
                scores=dets["scores"][i][keep], class_names=class_names,
            )
            cv2.imwrite(os.path.join(images_dir, os.path.basename(path)),
                        cv2.cvtColor(annotated, cv2.COLOR_RGB2BGR))

    n_det = int(sum(len(p["scores"]) for p in preds))
    print(json.dumps({
        "images": len(dets["image_paths"]),
        "detections": n_det,
        "results": results_path,
        "detections_in_json": len(results),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
