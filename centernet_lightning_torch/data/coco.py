"""COCO detection dataset — self-contained JSON parser (no pycocotools; a
copy of the JAX package's data/coco.py, with OpenCV imported only when an
image is read).

Reimplements the reference's CocoDetection (reference datasets/coco.py:28-94)
semantics: category-id -> contiguous-label mapping, per-image target preload,
boxes clipped to the image, boxes with a side <= 1 px dropped. Internal box
format is pixel xywh (COCO native).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["CocoDetection", "load_coco_annotations"]


def load_coco_annotations(ann_json: str):
    """Parse a COCO instances JSON. Returns (images, targets, label_map,
    cat_names): images is a list of dicts {id, file_name, width, height};
    targets maps image_id -> {'boxes': xywh list, 'labels': contiguous}."""
    with open(ann_json) as f:
        data = json.load(f)

    categories = sorted(data.get("categories", []), key=lambda c: c["id"])
    label_map = {c["id"]: i for i, c in enumerate(categories)}  # contiguous (coco.py:39-41)
    cat_names = [c["name"] for c in categories]

    images = sorted(data["images"], key=lambda x: x["id"])
    targets: Dict[int, Dict[str, list]] = {
        img["id"]: {"boxes": [], "labels": [], "iscrowd": [], "area": []}
        for img in images
    }
    dims = {img["id"]: (img["width"], img["height"]) for img in images}

    for ann in data.get("annotations", []):
        img_id = ann["image_id"]
        if img_id not in targets:
            continue
        w_img, h_img = dims[img_id]
        x, y, w, h = ann["bbox"]
        # clip to image (reference _clip_box, coco.py:18-25)
        x2, y2 = min(x + w, w_img), min(y + h, h_img)
        x, y = max(x, 0.0), max(y, 0.0)
        w, h = x2 - x, y2 - y
        if w <= 1 or h <= 1:  # drop degenerate boxes (coco.py:60-67)
            continue
        # crowd regions are kept (the reference loads all anns,
        # coco.py:48-55) and flagged so the evaluator can ignore-match
        # them with pycocotools IoF semantics
        targets[img_id]["boxes"].append([x, y, w, h])
        targets[img_id]["labels"].append(label_map[ann["category_id"]])
        targets[img_id]["iscrowd"].append(int(ann.get("iscrowd", 0)))
        # pycocotools gates GT area ranges on the annotation's own `area`
        # (the segmentation area — smaller than the box for real masks;
        # COCOeval.evaluateImg via _prepare's ann['area']). Carry it, box
        # w*h when absent (the reference's in-memory create_coco does the
        # same fallback, eval/coco.py:90).
        targets[img_id]["area"].append(float(ann.get("area", w * h)))

    return images, targets, label_map, cat_names


class CocoDetection:
    def __init__(
        self,
        img_dir: str,
        ann_json: str,
        transforms: Optional[Callable] = None,
    ):
        self.img_dir = img_dir
        self.transforms = transforms
        self.images, self.targets, self.label_map, self.cat_names = (
            load_coco_annotations(ann_json)
        )
        self.num_classes = len(self.cat_names)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict:
        info = self.images[idx]
        path = os.path.join(self.img_dir, info["file_name"])
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

        target = self.targets[info["id"]]
        sample = {
            "image": img,
            "bboxes": np.asarray(target["boxes"], np.float32).reshape(-1, 4),
            "labels": np.asarray(target["labels"], np.int64),
            "iscrowd": np.asarray(target["iscrowd"], np.int64),
            "area": np.asarray(target["area"], np.float32),
            "image_id": info["id"],
        }
        if self.transforms is not None:
            image_id = sample.pop("image_id")
            sample = self.transforms(sample)
            sample["image_id"] = image_id
        return sample
