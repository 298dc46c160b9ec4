"""Synthetic COCO-format "shapes" detection datasets (a copy of
tools/make_shapes_dataset.py, so that the port needs nothing of tools/).

v1 (`make_shapes_dataset`): 3 classes (rectangle / ellipse / triangle)
drawn bright on a dark noisy background. v2 (`make_shapes_v2_dataset`):
20 classes (4 shapes x 5 hues) at 256^2 with every COCO area bucket
populated, clutter and iscrowd clusters. The annotation `area` is the
drawn shape's true area, not the box's w*h. For the same arguments and
seed both write the same JPEG bytes and JSON as the tool does.

Writes <out>/images/*.jpg, <out>/train.json, <out>/val.json. OpenCV is
imported inside the functions that draw and write.
"""
from __future__ import annotations

import json
import os

import numpy as np

CLASSES = ["rectangle", "ellipse", "triangle"]


def draw_shape(img, cls: int, x: int, y: int, w: int, h: int, color):
    """Draw one shape into img; returns the true filled area in px^2."""
    import cv2

    if cls == 0:
        cv2.rectangle(img, (x, y), (x + w - 1, y + h - 1), color, -1)
        return float(w * h)
    if cls == 1:
        cv2.ellipse(img, (x + w // 2, y + h // 2), (w // 2, h // 2), 0,
                    0, 360, color, -1)
        return float(np.pi * (w / 2) * (h / 2))
    pts = np.array([[x + w // 2, y], [x, y + h - 1], [x + w - 1, y + h - 1]])
    cv2.fillPoly(img, [pts], color)
    return float(w * h / 2)


def make_shapes_dataset(out_dir: str, n_images: int = 200, size: int = 128,
                        min_shapes: int = 1, max_shapes: int = 4,
                        val_fraction: float = 0.2, seed: int = 0):
    import cv2

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    ann_id = 1
    if size < 32:
        raise ValueError(f"--size must be >= 32 (got {size}): shapes are "
                         "12+ px and need placement margin")
    for i in range(n_images):
        img = rng.integers(5, 45, (size, size, 3)).astype(np.uint8)
        # clamp so x/y placement (below) always has a nonempty range
        smax = min(max(24, size // 4), size - 14)
        for _ in range(int(rng.integers(min_shapes, max_shapes + 1))):
            w = int(rng.integers(12, smax))
            h = int(rng.integers(12, smax))
            x = int(rng.integers(1, size - w - 1))
            y = int(rng.integers(1, size - h - 1))
            cls = int(rng.integers(0, len(CLASSES)))
            color = tuple(int(c) for c in rng.integers(120, 256, 3))
            area = draw_shape(img, cls, x, y, w, h, color)
            annotations.append({
                "id": ann_id, "image_id": i + 1,
                "category_id": cls + 1, "bbox": [x, y, w, h],
                "area": area, "iscrowd": 0,
            })
            ann_id += 1
        cv2.imwrite(os.path.join(img_dir, f"{i:05d}.jpg"), img)
        images.append({"id": i + 1, "file_name": f"{i:05d}.jpg",
                       "width": size, "height": size})

    categories = [{"id": c + 1, "name": name}
                  for c, name in enumerate(CLASSES)]
    n_val = int(round(n_images * val_fraction))
    val_ids = {img["id"] for img in images[n_images - n_val:]}

    def write(path, subset_ids):
        subset = [img for img in images if img["id"] in subset_ids]
        anns = [a for a in annotations if a["image_id"] in subset_ids]
        with open(path, "w") as f:
            json.dump({"images": subset, "annotations": anns,
                       "categories": categories}, f)
        return len(subset), len(anns)

    train_ids = {img["id"] for img in images} - val_ids
    nt, at = write(os.path.join(out_dir, "train.json"), train_ids)
    nv, av = write(os.path.join(out_dir, "val.json"), val_ids)
    return {"img_dir": img_dir, "train": (nt, at), "val": (nv, av)}


# ---------------------------------------------------------------------------
# v2: multi-scale benchmark set
# ---------------------------------------------------------------------------
# The v1 set is single-scale (3 classes at 128^2), so AP_medium/AP_large
# stay empty and a neck comparison sees no cross-scale signal. v2:
#  - 256^2 images, 20 classes = 4 shapes x 5 hue bands (both attributes
#    must be read to classify)
#  - box sides sampled per COCO area bucket (small < 32^2 px^2, medium
#    32^2..96^2, large > 96^2 — pycocotools areaRng semantics, reference
#    eval/coco.py:24-27), every bucket populated in train AND val
#  - unannotated low-contrast clutter distractors
#  - occasional iscrowd=1 cluster regions (union box over a packed group;
#    the evaluator must ignore-match them, reference eval/coco.py protocol)

V2_SHAPES = ["rectangle", "ellipse", "triangle", "cross"]
V2_HUES = [  # BGR bands; value high so shapes stay bright vs clutter
    ("red", (40, 40, 230)), ("green", (40, 220, 40)),
    ("blue", (235, 80, 40)), ("yellow", (40, 210, 230)),
    ("magenta", (230, 60, 230)),
]
V2_CLASSES = [f"{h}_{s}" for s in V2_SHAPES for h, _ in V2_HUES]


def _v2_draw(img, shape: int, x, y, w, h, color) -> float:
    import cv2

    if shape == 3:  # cross / plus
        aw, ah = max(w // 3, 2), max(h // 3, 2)
        cv2.rectangle(img, (x + (w - aw) // 2, y),
                      (x + (w + aw) // 2 - 1, y + h - 1), color, -1)
        cv2.rectangle(img, (x, y + (h - ah) // 2),
                      (x + w - 1, y + (h + ah) // 2 - 1), color, -1)
        return float(aw * h + ah * w - aw * ah)
    return draw_shape(img, shape, x, y, w, h, color)


def _v2_side(rng, bucket: str, size: int):
    """Sample (w, h) whose TRUE area lands in the COCO bucket (shape areas
    are < w*h, so aim the box area comfortably inside the bucket)."""
    if bucket == "small":
        lo, hi = 10, 30
    elif bucket == "medium":
        lo, hi = 44, 92
    else:
        lo, hi = 112, min(200, size - 16)
    w = int(rng.integers(lo, hi + 1))
    h = int(rng.integers(lo, hi + 1))
    return w, h


def make_shapes_v2_dataset(out_dir: str, n_images: int = 300,
                           size: int = 256, val_fraction: float = 0.2,
                           seed: int = 0):
    import cv2

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    ann_id = 1
    buckets = ["small", "medium", "large"]
    for i in range(n_images):
        img = rng.integers(5, 45, (size, size, 3)).astype(np.uint8)
        # clutter first (shapes draw over it): dim blobs + texture streaks
        for _ in range(int(rng.integers(3, 8))):
            cw, ch = int(rng.integers(8, 60)), int(rng.integers(8, 60))
            cx = int(rng.integers(0, size - cw))
            cy = int(rng.integers(0, size - ch))
            color = tuple(int(c) for c in rng.integers(40, 95, 3))
            _v2_draw(img, int(rng.integers(0, 4)), cx, cy, cw, ch, color)
        # one object per bucket guaranteed, plus 0-4 extra random-bucket
        todo = buckets + [buckets[int(rng.integers(0, 3))]
                          for _ in range(int(rng.integers(0, 5)))]
        for bucket in todo:
            w, h = _v2_side(rng, bucket, size)
            x = int(rng.integers(1, size - w - 1))
            y = int(rng.integers(1, size - h - 1))
            shape = int(rng.integers(0, len(V2_SHAPES)))
            hue = int(rng.integers(0, len(V2_HUES)))
            base = np.asarray(V2_HUES[hue][1], np.int32)
            jitter = rng.integers(-25, 26, 3)
            color = tuple(int(np.clip(c, 110, 255) if c > 100 else
                              np.clip(c, 20, 100))
                          for c in (base + jitter))
            area = _v2_draw(img, shape, x, y, w, h, color)
            annotations.append({
                "id": ann_id, "image_id": i + 1,
                "category_id": shape * len(V2_HUES) + hue + 1,
                "bbox": [x, y, w, h], "area": area, "iscrowd": 0,
            })
            ann_id += 1
        # ~12% of images: an iscrowd cluster (packed small shapes of one
        # class, union box annotated iscrowd=1)
        if rng.uniform() < 0.12:
            gw, gh = int(rng.integers(60, 100)), int(rng.integers(60, 100))
            gx = int(rng.integers(1, size - gw - 1))
            gy = int(rng.integers(1, size - gh - 1))
            shape = int(rng.integers(0, len(V2_SHAPES)))
            hue = int(rng.integers(0, len(V2_HUES)))
            color = V2_HUES[hue][1]
            area = 0.0
            for _ in range(int(rng.integers(5, 9))):
                sw, sh = int(rng.integers(8, 20)), int(rng.integers(8, 20))
                sx = int(rng.integers(gx, gx + gw - sw))
                sy = int(rng.integers(gy, gy + gh - sh))
                area += _v2_draw(img, shape, sx, sy, sw, sh, color)
            annotations.append({
                "id": ann_id, "image_id": i + 1,
                "category_id": shape * len(V2_HUES) + hue + 1,
                "bbox": [gx, gy, gw, gh], "area": min(area, gw * gh),
                "iscrowd": 1,
            })
            ann_id += 1
        cv2.imwrite(os.path.join(img_dir, f"{i:05d}.jpg"), img)
        images.append({"id": i + 1, "file_name": f"{i:05d}.jpg",
                       "width": size, "height": size})

    categories = [{"id": c + 1, "name": name}
                  for c, name in enumerate(V2_CLASSES)]
    n_val = int(round(n_images * val_fraction))
    val_ids = {img["id"] for img in images[n_images - n_val:]}
    train_ids = {img["id"] for img in images} - val_ids

    def write(path, subset_ids):
        subset = [img for img in images if img["id"] in subset_ids]
        anns = [a for a in annotations if a["image_id"] in subset_ids]
        with open(path, "w") as f:
            json.dump({"images": subset, "annotations": anns,
                       "categories": categories}, f)
        return len(subset), len(anns)

    nt, at = write(os.path.join(out_dir, "train.json"), train_ids)
    nv, av = write(os.path.join(out_dir, "val.json"), val_ids)
    return {"img_dir": img_dir, "train": (nt, at), "val": (nv, av)}
