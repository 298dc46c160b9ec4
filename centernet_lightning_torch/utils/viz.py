"""Box drawing for `inference_tracking`'s annotated frames (port of
utils/viz.py:draw_boxes; the other diagnostics are not ported yet). cv2 is
imported inside the function that draws."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["draw_boxes"]

_COLORS = np.array([
    (220, 20, 60), (0, 149, 255), (0, 255, 146), (255, 186, 0),
    (182, 0, 255), (0, 255, 255), (255, 64, 0), (128, 255, 0),
], np.float64)


def _denormalize(img: np.ndarray) -> np.ndarray:
    """Any float image -> uint8 for drawing."""
    if img.dtype == np.uint8:
        return img.copy()
    lo, hi = float(img.min()), float(img.max())
    if hi <= lo:
        return np.zeros_like(img, np.uint8)
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def draw_boxes(
    img: np.ndarray, boxes, labels=None, scores=None,
    class_names: Optional[Sequence[str]] = None,
    normalized_boxes: bool = False, color=None, thickness: int = 2,
) -> np.ndarray:
    """Draw xyxy boxes with label/score text chips. Returns a uint8 copy."""
    import cv2

    img = np.ascontiguousarray(_denormalize(img))
    h, w = img.shape[:2]
    boxes = np.asarray(boxes, float).reshape(-1, 4)
    if normalized_boxes:
        boxes = boxes * np.array([w, h, w, h])
    for i, box in enumerate(boxes):
        label = int(labels[i]) if labels is not None else 0
        c = tuple(map(int, color or _COLORS[label % len(_COLORS)]))
        x1, y1, x2, y2 = map(int, box)
        cv2.rectangle(img, (x1, y1), (x2, y2), c, thickness)
        text = ""
        if class_names is not None:
            text = class_names[label]
        elif labels is not None:
            text = str(label)
        if scores is not None:
            text = f"{text} {float(scores[i]):.2f}".strip()
        if text:
            (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.4, 1)
            cv2.rectangle(img, (x1, y1 - th - 4), (x1 + tw + 2, y1), c, -1)
            cv2.putText(img, text, (x1 + 1, y1 - 3), cv2.FONT_HERSHEY_SIMPLEX,
                        0.4, (255, 255, 255), 1, cv2.LINE_AA)
    return img
