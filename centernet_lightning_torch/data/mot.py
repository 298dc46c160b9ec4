"""MOT-Challenge tracking dataset (seqinfo.ini + gt.txt sequences; a copy
of the JAX package's data/mot.py, with OpenCV imported only when an image
is read).

Reimplements the reference MOTTrackingSequence/Dataset (reference
datasets/mot.py:7-120): per-frame {image, bboxes, labels, ids}; only class 1
(pedestrian) kept; 1-indexed ids converted to 0-indexed; sequences
concatenated with global track-id offsets. Internal format: pixel xywh.
"""
from __future__ import annotations

import configparser
import os
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["MOTTrackingSequence", "MOTTrackingDataset"]


class MOTTrackingSequence:
    def __init__(self, seq_dir: str, transforms: Optional[Callable] = None):
        self.seq_dir = seq_dir
        self.transforms = transforms
        self.num_classes = 1

        ini = configparser.ConfigParser()
        ini.read(os.path.join(seq_dir, "seqinfo.ini"))
        seq = ini["Sequence"]
        self.img_dir = os.path.join(seq_dir, seq.get("imDir", "img1"))
        self.img_w = int(seq["imWidth"])
        self.img_h = int(seq["imHeight"])
        self.seq_length = int(seq["seqLength"])
        self.img_ext = seq.get("imExt", ".jpg")
        self.frame_rate = float(seq.get("frameRate", 30))
        self.name = seq.get("name", os.path.basename(seq_dir))

        # frame -> {ids, bboxes}
        self.frames: Dict[int, Dict[str, list]] = {
            f: {"ids": [], "bboxes": []} for f in range(1, self.seq_length + 1)
        }
        self.track_ids: set = set()
        gt_path = os.path.join(seq_dir, "gt", "gt.txt")
        if os.path.exists(gt_path):
            with open(gt_path) as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) < 8:
                        continue
                    frame, tid = int(parts[0]), int(parts[1])
                    x, y, w, h = map(float, parts[2:6])
                    conf = float(parts[6])
                    cls = int(float(parts[7]))
                    if cls != 1 or conf == 0:  # pedestrians only (mot.py:65)
                        continue
                    # 1-indexed coords -> 0-indexed, clip (mot.py semantics)
                    x, y = x - 1, y - 1
                    x2 = min(x + w, self.img_w)
                    y2 = min(y + h, self.img_h)
                    x, y = max(x, 0.0), max(y, 0.0)
                    if x2 - x <= 1 or y2 - y <= 1:
                        continue
                    if frame in self.frames:
                        self.frames[frame]["ids"].append(tid - 1)
                        self.frames[frame]["bboxes"].append([x, y, x2 - x, y2 - y])
                        self.track_ids.add(tid - 1)

    @property
    def num_tracks(self) -> int:
        return (max(self.track_ids) + 1) if self.track_ids else 0

    def __len__(self) -> int:
        return self.seq_length

    def get_raw(self, idx: int, id_offset: int = 0) -> Dict:
        frame = idx + 1
        path = os.path.join(self.img_dir, f"{frame:06d}{self.img_ext}")
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        data = self.frames[frame]
        return {
            "image": img,
            "bboxes": np.asarray(data["bboxes"], np.float32).reshape(-1, 4),
            "labels": np.zeros(len(data["ids"]), np.int64),
            "ids": np.asarray(data["ids"], np.int64) + id_offset,
        }

    def __getitem__(self, idx: int) -> Dict:
        sample = self.get_raw(idx)
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample


class MOTTrackingDataset:
    """Concatenated sequences with global track-id offsetting
    (reference mot.py:18-31)."""

    def __init__(self, data_dir: str, sequence_names: Optional[List[str]] = None,
                 transforms: Optional[Callable] = None):
        self.transforms = transforms
        self.num_classes = 1
        if sequence_names is None:
            sequence_names = sorted(
                d for d in os.listdir(data_dir)
                if os.path.isdir(os.path.join(data_dir, d))
            )
        self.sequences = [
            MOTTrackingSequence(os.path.join(data_dir, name))
            for name in sequence_names
        ]
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
        # sequence boundary marker: validation resets the tracker and
        # evaluates per sequence (reference eval/mot_challenge.py:9-83)
        sample["sequence_id"] = s
        return sample
