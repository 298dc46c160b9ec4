"""KITTI tracking dataset (label_02 txt sequences; a copy of the JAX
package's data/kitti.py, with OpenCV imported only when an image is read).

Reimplements the reference KITTITrackingSequence/Dataset (reference
datasets/kitti.py:6-116): 8-class default name map, per-frame
{image, bboxes, labels, ids}. Internal format: pixel xywh.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["KITTITrackingSequence", "KITTITrackingDataset", "KITTI_CLASSES"]

KITTI_CLASSES = [
    "Car", "Van", "Truck", "Pedestrian", "Person_sitting", "Cyclist",
    "Tram", "Misc",
]


class KITTITrackingSequence:
    def __init__(self, image_dir: str, label_file: str,
                 transforms: Optional[Callable] = None,
                 class_names: Optional[List[str]] = None):
        self.image_dir = image_dir
        self.transforms = transforms
        self.class_names = class_names or KITTI_CLASSES
        name_to_label = {n: i for i, n in enumerate(self.class_names)}
        self.num_classes = len(self.class_names)

        self.image_files = sorted(
            f for f in os.listdir(image_dir) if f.endswith((".png", ".jpg"))
        )
        self.frames: Dict[int, Dict[str, list]] = {
            i: {"ids": [], "labels": [], "bboxes": []}
            for i in range(len(self.image_files))
        }
        self.track_ids: set = set()
        with open(label_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 10:
                    continue
                frame, tid = int(parts[0]), int(parts[1])
                cls = parts[2]
                if cls not in name_to_label or tid < 0:
                    continue
                x1, y1, x2, y2 = map(float, parts[6:10])
                if x2 - x1 <= 1 or y2 - y1 <= 1 or frame not in self.frames:
                    continue
                self.frames[frame]["ids"].append(tid)
                self.frames[frame]["labels"].append(name_to_label[cls])
                self.frames[frame]["bboxes"].append([x1, y1, x2 - x1, y2 - y1])
                self.track_ids.add(tid)

    @property
    def num_tracks(self) -> int:
        return (max(self.track_ids) + 1) if self.track_ids else 0

    def __len__(self) -> int:
        return len(self.image_files)

    def get_raw(self, idx: int, id_offset: int = 0) -> Dict:
        path = os.path.join(self.image_dir, self.image_files[idx])
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        data = self.frames[idx]
        # boxes clipped to actual image dims at getitem (kitti.py:97-101)
        h_img, w_img = img.shape[:2]
        boxes = np.asarray(data["bboxes"], np.float32).reshape(-1, 4)
        if len(boxes):
            x2 = np.minimum(boxes[:, 0] + boxes[:, 2], w_img)
            y2 = np.minimum(boxes[:, 1] + boxes[:, 3], h_img)
            boxes[:, 0] = np.maximum(boxes[:, 0], 0)
            boxes[:, 1] = np.maximum(boxes[:, 1], 0)
            boxes[:, 2] = x2 - boxes[:, 0]
            boxes[:, 3] = y2 - boxes[:, 1]
        return {
            "image": img,
            "bboxes": boxes,
            "labels": np.asarray(data["labels"], np.int64),
            "ids": np.asarray(data["ids"], np.int64) + id_offset,
        }

    def __getitem__(self, idx: int) -> Dict:
        sample = self.get_raw(idx)
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample


class KITTITrackingDataset:
    def __init__(self, data_dir: str, split: str = "training",
                 sequence_names: Optional[List[str]] = None,
                 transforms: Optional[Callable] = None):
        self.transforms = transforms
        image_root = os.path.join(data_dir, split, "image_02")
        label_root = os.path.join(data_dir, split, "label_02")
        if sequence_names is None:
            sequence_names = sorted(
                d for d in os.listdir(image_root)
                if os.path.isdir(os.path.join(image_root, d))
            )
        self.sequences = [
            KITTITrackingSequence(
                os.path.join(image_root, name),
                os.path.join(label_root, f"{name}.txt"),
            )
            for name in sequence_names
        ]
        self.num_classes = self.sequences[0].num_classes if self.sequences else 8
        self.id_offsets = []
        offset = 0
        for seq in self.sequences:
            self.id_offsets.append(offset)
            offset += seq.num_tracks
        self.max_track_ids = offset

        self.index = []
        for s, seq in enumerate(self.sequences):
            self.index.extend((s, i) for i in range(len(seq)))

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> Dict:
        s, i = self.index[idx]
        sample = self.sequences[s].get_raw(i, id_offset=self.id_offsets[s])
        if self.transforms is not None:
            sample = self.transforms(sample)
        sample["sequence_id"] = s
        return sample
