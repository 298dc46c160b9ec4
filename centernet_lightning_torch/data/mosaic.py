"""4-image Mosaic augmentation (dataset wrapper; a copy of the JAX
package's data/mosaic.py, with OpenCV imported only when a sample is made).

The reference ships Mosaic as an unimplemented stub
(reference datasets/transforms.py:29-34); this is the real thing (YOLOv4
recipe): four samples tiled around a random center on a 2x-size canvas,
boxes shifted/clipped, then the canvas is resized back to the target size.
Implemented as a dataset wrapper (a per-sample transform cannot see other
samples)."""
from __future__ import annotations

import numpy as np

__all__ = ["MosaicDataset"]


class MosaicDataset:
    """Wraps a detection/tracking dataset; with probability `p`, __getitem__
    returns a 4-image mosaic at (out_h, out_w). The wrapped dataset should
    NOT normalize in its own transforms when mosaic is used — give the
    post-pipeline (e.g. Normalize) via `post_transforms`."""

    def __init__(self, dataset, out_h: int = 512, out_w: int = 512,
                 p: float = 1.0, seed: int = 0, post_transforms=None,
                 min_box_side: float = 2.0):
        import threading

        self.dataset = dataset
        self.out_h, self.out_w = out_h, out_w
        self.p = p
        self.rng = np.random.default_rng(seed)
        self._lock = threading.Lock()  # generators aren't thread-safe
        self.post_transforms = post_transforms
        self.min_box_side = min_box_side
        self.num_classes = getattr(dataset, "num_classes", None)

    def __len__(self) -> int:
        return len(self.dataset)

    def _finish(self, sample):
        if self.post_transforms is not None:
            sample = self.post_transforms(sample)
        return sample

    def __getitem__(self, idx: int):
        with self._lock:
            rng = np.random.default_rng(self.rng.integers(2 ** 63))
        return self._get(idx, rng)

    def _get(self, idx: int, rng):
        import cv2

        if rng.uniform() >= self.p:
            sample = dict(self.dataset[idx])
            img = sample["image"]
            if img.shape[:2] != (self.out_h, self.out_w):
                sx = self.out_w / img.shape[1]
                sy = self.out_h / img.shape[0]
                scale = np.array([sx, sy, sx, sy], np.float32)
                sample["image"] = cv2.resize(img, (self.out_w, self.out_h))
                if len(sample["bboxes"]):
                    sample["bboxes"] = sample["bboxes"] * scale
                if "area" in sample and len(sample["area"]):
                    # annotation area lives in the coordinate space of the
                    # boxes (pycocotools GT area-range source)
                    sample["area"] = np.asarray(
                        sample["area"], np.float32) * (sx * sy)
            return self._finish(sample)

        H, W = self.out_h, self.out_w
        canvas = np.zeros((2 * H, 2 * W, 3), np.uint8)
        # random mosaic center in the middle half of the canvas
        cx = int(rng.integers(W // 2, W + W // 2))
        cy = int(rng.integers(H // 2, H + H // 2))

        indices = [idx] + [int(rng.integers(0, len(self.dataset)))
                           for _ in range(3)]
        boxes_all, labels_all, ids_all = [], [], []
        area_all, crowd_all = [], []
        has_ids = has_area = has_crowd = None
        # quadrant regions: (x1, y1, x2, y2) on the canvas
        regions = [(0, 0, cx, cy), (cx, 0, 2 * W, cy),
                   (0, cy, cx, 2 * H), (cx, cy, 2 * W, 2 * H)]
        for i, region in zip(indices, regions):
            item = self.dataset[i]
            img = item["image"]
            rx1, ry1, rx2, ry2 = region
            rw, rh = rx2 - rx1, ry2 - ry1
            if rw <= 0 or rh <= 0:
                continue
            resized = cv2.resize(img, (rw, rh))
            canvas[ry1:ry2, rx1:rx2] = resized
            if has_ids is None:
                has_ids = "ids" in item
                has_area = "area" in item
                has_crowd = "iscrowd" in item
            boxes = np.asarray(item["bboxes"], np.float32).reshape(-1, 4)
            if len(boxes):
                sx, sy = rw / img.shape[1], rh / img.shape[0]
                boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
                boxes[:, 0] += rx1
                boxes[:, 1] += ry1
                boxes_all.append(boxes)
                labels_all.append(np.asarray(item["labels"]))
                if has_ids:
                    ids_all.append(np.asarray(item["ids"]))
                if has_area:
                    # annotation area scales with the coordinate space
                    area_all.append(
                        np.asarray(item["area"], np.float32) * (sx * sy))
                if has_crowd:
                    crowd_all.append(np.asarray(item["iscrowd"], np.int64))

        boxes = (np.concatenate(boxes_all) if boxes_all
                 else np.zeros((0, 4), np.float32))
        labels = (np.concatenate(labels_all) if labels_all
                  else np.zeros((0,), np.int64))
        ids = (np.concatenate(ids_all) if ids_all
               else np.zeros((0,), np.int64))
        areas = (np.concatenate(area_all) if area_all
                 else np.zeros((0,), np.float32))
        crowds = (np.concatenate(crowd_all) if crowd_all
                  else np.zeros((0,), np.int64))

        # canvas (2H, 2W) -> (H, W)
        image = cv2.resize(canvas, (W, H))
        boxes = boxes * 0.5
        areas = areas * 0.25
        # clip + filter tiny remnants
        if len(boxes):
            unclipped = np.maximum(boxes[:, 2] * boxes[:, 3], 1e-6)
            x2 = np.clip(boxes[:, 0] + boxes[:, 2], 0, W)
            y2 = np.clip(boxes[:, 1] + boxes[:, 3], 0, H)
            boxes[:, 0] = np.clip(boxes[:, 0], 0, W)
            boxes[:, 1] = np.clip(boxes[:, 1], 0, H)
            boxes[:, 2] = x2 - boxes[:, 0]
            boxes[:, 3] = y2 - boxes[:, 1]
            keep = (boxes[:, 2] > self.min_box_side) & (boxes[:, 3] > self.min_box_side)
            if len(areas):
                # shrink annotation area by the visible-box fraction
                areas = areas * (boxes[:, 2] * boxes[:, 3] / unclipped)
                areas = areas[keep]
            boxes, labels = boxes[keep], labels[keep]
            if len(ids):
                ids = ids[keep]
            if len(crowds):
                crowds = crowds[keep]

        sample = {"image": image, "bboxes": boxes, "labels": labels}
        if has_ids:
            sample["ids"] = ids
        if has_area:
            sample["area"] = areas
        if has_crowd:
            sample["iscrowd"] = crowds
        return self._finish(sample)
