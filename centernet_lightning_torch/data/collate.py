"""Padded-batch collation (a copy of the JAX package's data/collate.py).

The reference's CollateDetection/CollateTracking (reference
datasets/utils.py:41-114) pad boxes/labels(/ids) to the max count in the
batch and emit a 0/1 mask. A FIXED pad size (`max_boxes`) is supported as
well, so every batch has the same shapes as the JAX package's.
Boxes beyond max_boxes are dropped (COCO p99.9 is < 100 objects/image).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np

__all__ = ["CollateDetection", "CollateTracking", "collate_detection",
           "collate_tracking", "coco_detection_collate_fn"]


def _pad_batch(batch: List[Dict], keys, max_boxes: Optional[int],
               on_truncate=None) -> Dict[str, np.ndarray]:
    n = len(batch)
    k = max((len(x["labels"]) for x in batch), default=0)
    if max_boxes is not None:
        if k > max_boxes and on_truncate is not None:
            on_truncate(k)
        k = max_boxes
    k = max(k, 1)

    # collated batches use the task's canonical key "boxes" (dataset samples
    # keep the reference's "bboxes"; this boundary is the rename point).
    # uint8 images are KEPT uint8 — the train/eval step normalizes them on
    # the device (make_train_step docstring; 4x smaller H2D). A float32
    # image here means the host pipeline already ran Normalize.
    images = np.stack([x["image"] for x in batch])
    out = {
        "image": images if images.dtype == np.uint8
        else images.astype(np.float32),
        "boxes": np.zeros((n, k, 4), np.float32),
        "labels": np.zeros((n, k), np.int32),
        "mask": np.zeros((n, k), np.float32),
    }
    if "ids" in keys:
        out["ids"] = np.zeros((n, k), np.int32)
    if all("image_id" in x for x in batch):
        out["image_id"] = np.asarray([x["image_id"] for x in batch], np.int64)
    if n > 0 and all("sequence_id" in x for x in batch):
        out["sequence_id"] = np.asarray(
            [x["sequence_id"] for x in batch], np.int64)
    has_crowd = n > 0 and all("iscrowd" in x for x in batch)
    if has_crowd:
        out["iscrowd"] = np.zeros((n, k), np.int32)
    # annotation area (pycocotools GT area-range source) rides along like
    # iscrowd: eval-only, zero-padded
    has_area = n > 0 and all("area" in x for x in batch)
    if has_area:
        out["area"] = np.zeros((n, k), np.float32)

    for b, item in enumerate(batch):
        m = min(len(item["labels"]), k)
        if m > 0:
            out["boxes"][b, :m] = item["bboxes"][:m]
            out["labels"][b, :m] = item["labels"][:m]
            out["mask"][b, :m] = 1
            if "ids" in keys:
                out["ids"][b, :m] = item["ids"][:m]
            if has_crowd:
                out["iscrowd"][b, :m] = np.asarray(item["iscrowd"])[:m]
            if has_area:
                out["area"][b, :m] = np.asarray(item["area"])[:m]
    return out


class _TruncationWarner:
    """Warn ONCE per collate instance when an image carries more boxes than
    `max_boxes` — the extra GT is silently dropped from both training
    targets and eval (the reference passes unpadded target lists,
    centernet.py:202-212, so it never truncates; our fixed-shape contract
    does). On crowded datasets (CrowdHuman: 400+ boxes/image) raise
    `max_boxes` in the data config or eval mAP is biased."""

    def __init__(self):
        self.truncated_batches = 0

    def __call__(self, owner, seen: int):
        self.truncated_batches += 1
        if self.truncated_batches == 1:
            warnings.warn(
                f"{type(owner).__name__}: an image has {seen} boxes but "
                f"max_boxes={owner.max_boxes}; the excess is DROPPED (from "
                "training targets and eval GT). Raise max_boxes in the "
                "data config for crowded datasets.",
                RuntimeWarning, stacklevel=4)


class CollateDetection:
    """items {image, bboxes, labels} -> padded {image, boxes, labels, mask}
    (dataset "bboxes" renamed to batch "boxes" here — the repo convention).
    Warns on the first batch that overflows max_boxes; the count of
    truncated batches is exposed as `truncation.truncated_batches`."""

    def __init__(self, max_boxes: Optional[int] = 128):
        self.max_boxes = max_boxes
        self.truncation = _TruncationWarner()

    def __call__(self, batch: List[Dict]) -> Dict[str, np.ndarray]:
        return _pad_batch(batch, ("bboxes", "labels"), self.max_boxes,
                          lambda seen: self.truncation(self, seen))


class CollateTracking:
    """items {image, bboxes, labels, ids} -> padded + ids."""

    def __init__(self, max_boxes: Optional[int] = 256):
        self.max_boxes = max_boxes
        self.truncation = _TruncationWarner()

    def __call__(self, batch: List[Dict]) -> Dict[str, np.ndarray]:
        return _pad_batch(batch, ("bboxes", "labels", "ids"), self.max_boxes,
                          lambda seen: self.truncation(self, seen))


collate_detection = CollateDetection()
collate_tracking = CollateTracking()


def coco_detection_collate_fn(batch):
    """The reference's simple non-padded collate (reference
    datasets/coco.py:97-100): stacked images + a tuple of per-sample
    target dicts (variable length). The padded CollateDetection is the
    contract of the train and eval steps; this exists for API parity and
    host-side tooling."""
    images = np.stack([s["image"] for s in batch], axis=0)
    targets = tuple(
        {k: v for k, v in s.items() if k != "image"} for s in batch
    )
    return images, targets
