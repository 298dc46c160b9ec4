"""Folder-of-images inference dataset (port of data/inference.py).

Image names are discovered and sorted; each item is a uint8 RGB frame,
optionally host-resized to the batch shape, with its original size so
decoded boxes can be scaled back. Normalisation runs on the device
(`ops/preprocess.py`). OpenCV is imported only when an image is read.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

__all__ = ["InferenceDataset"]

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class InferenceDataset:
    def __init__(self, img_dir: str,
                 resize: Optional[Tuple[int, int]] = (512, 512)):
        self.img_dir = img_dir
        self.resize = resize
        self.files = sorted(
            f for f in os.listdir(img_dir) if f.lower().endswith(_IMG_EXTS)
        )

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        import cv2

        path = os.path.join(self.img_dir, self.files[idx])
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        h, w = img.shape[:2]
        if self.resize is not None:
            img = cv2.resize(img, (self.resize[1], self.resize[0]))
        return {
            "image_path": path,
            "image": img,
            "original_height": h,
            "original_width": w,
        }
