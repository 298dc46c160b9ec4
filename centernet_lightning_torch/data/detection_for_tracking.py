"""Adapter: detection dataset -> tracking dataset with synthetic track ids
(a copy of the JAX package's data/detection_for_tracking.py).

Reimplements the reference DetectionForTracking (reference
datasets/detection_for_tracking.py:3-40): every GT box in the wrapped
detection dataset gets a globally unique synthetic identity, which lets
FairMOT's ReID classifier pretrain on detection data (CrowdHuman recipe,
configs/crowdhuman_tracking.yaml:50).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["DetectionForTracking"]


class DetectionForTracking:
    def __init__(self, dataset):
        self.dataset = dataset
        self.num_classes = getattr(dataset, "num_classes", 1)
        # steal the wrapped dataset's transform pipeline (the reference does
        # the same, detection_for_tracking.py:15-17) so ids are attached
        # BEFORE augmentation and stay aligned through box filtering
        self.transforms = getattr(dataset, "transforms", None)
        if self.transforms is not None:
            dataset.transforms = None
        # global per-box id offsets: ids are unique across the whole dataset
        counts = []
        for i in range(len(dataset)):
            counts.append(self._num_boxes(dataset, i))
        self.id_offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        self.max_track_ids = int(self.id_offsets[-1] + (counts[-1] if counts else 0))

    @staticmethod
    def _num_boxes(dataset, idx: int) -> int:
        # use annotation-only accessors when available: never decode
        # images just to count boxes (minutes of startup otherwise)
        if hasattr(dataset, "num_annotations"):
            return dataset.num_annotations(idx)
        targets = getattr(dataset, "targets", None)
        images = getattr(dataset, "images", None)
        if targets is not None and images is not None:
            return len(targets[images[idx]["id"]]["labels"])
        records = getattr(dataset, "records", None)
        if records is not None:
            # mirror CrowdHuman.__getitem__'s annotation-level filters
            # (tag + extra.ignore) so max_track_ids isn't inflated by the
            # large ignore fraction; the image-size-dependent degenerate-
            # box drop can't be applied without decoding, so this stays a
            # safe (slight) upper bound — ids remain unique either way
            return sum(
                1 for gt in records[idx].get("gtboxes", [])
                if gt.get("tag") == "person"
                and gt.get("extra", {}).get("ignore", 0) != 1
            )
        return len(dataset[idx]["labels"])

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Dict:
        sample = dict(self.dataset[idx])
        n = len(sample["labels"])
        sample["ids"] = self.id_offsets[idx] + np.arange(n, dtype=np.int64)
        if self.transforms is not None:
            image_id = sample.pop("image_id", None)
            sample = self.transforms(sample)
            if image_id is not None:
                sample["image_id"] = image_id
        return sample
