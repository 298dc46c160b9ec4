"""CrowdHuman dataset (.odgt JSON-lines annotations; a copy of the JAX
package's data/crowdhuman.py, with OpenCV imported only when an image is
read).

Reimplements the reference CrowdHumanDataset (reference
datasets/crowdhuman.py:8-86): fbox (full-body) boxes, clipped; persons with
head-tag 'mask' (ignore regions) filtered out. Internal format: pixel xywh.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["CrowdHumanDataset"]


class CrowdHumanDataset:
    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        transforms: Optional[Callable] = None,
        img_dir: Optional[str] = None,
    ):
        self.data_dir = data_dir
        self.img_dir = img_dir or os.path.join(data_dir, "Images")
        self.transforms = transforms
        self.num_classes = 1

        odgt = os.path.join(data_dir, f"annotation_{split}.odgt")
        self.records = []
        with open(odgt) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.records.append(json.loads(line))

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict:
        rec = self.records[idx]
        path = os.path.join(self.img_dir, rec["ID"] + ".jpg")
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        h_img, w_img = img.shape[:2]

        boxes, labels = [], []
        for gt in rec.get("gtboxes", []):
            # ignore-region filter (reference crowdhuman.py ignore_mask)
            if gt.get("tag") != "person":
                continue
            extra = gt.get("extra", {})
            if extra.get("ignore", 0) == 1:
                continue
            x, y, w, h = gt["fbox"]
            x2, y2 = min(x + w, w_img), min(y + h, h_img)
            x, y = max(x, 0.0), max(y, 0.0)
            if x2 - x <= 1 or y2 - y <= 1:
                continue
            boxes.append([x, y, x2 - x, y2 - y])
            labels.append(0)

        sample = {
            "image": img,
            "bboxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "image_id": idx,
        }
        if self.transforms is not None:
            image_id = sample.pop("image_id")
            sample = self.transforms(sample)
            sample["image_id"] = image_id
        return sample
