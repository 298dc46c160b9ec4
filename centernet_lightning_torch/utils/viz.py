"""Visualization and the Trainer's image diagnostics (port of utils/viz.py):
box drawing, heatmap overlays, colormaps, image grids and the W&B box
schema. cv2 and matplotlib are imported inside the functions that use them,
so the package loads without either."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "draw_boxes",
    "draw_heatmap",
    "apply_mpl_cmap",
    "make_image_grid",
    "render_heatmap_diagnostic",
    "convert_bboxes_to_wandb",
]

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


def apply_mpl_cmap(values: np.ndarray, cmap: str = "viridis") -> np.ndarray:
    """(..., H, W) scalar map -> (..., H, W, 3) uint8 colormap. Uses
    matplotlib when present, else a grayscale fallback."""
    values = np.asarray(values, np.float32)
    lo, hi = values.min(), values.max()
    norm = (values - lo) / (hi - lo) if hi > lo else np.zeros_like(values)
    try:
        from matplotlib import colormaps

        rgba = colormaps[cmap](norm)
        return (rgba[..., :3] * 255).astype(np.uint8)
    except Exception:
        g = (norm * 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)


def draw_heatmap(img: np.ndarray, heatmap: np.ndarray, alpha: float = 0.5,
                 cmap: str = "jet") -> np.ndarray:
    """Overlay a (H', W') or (H', W', C) heatmap on an image: the channel
    max is taken, colormapped, resized to the image and blended."""
    import cv2

    base = _denormalize(img)
    hm = np.asarray(heatmap, np.float32)
    if hm.ndim == 3:
        hm = hm.max(axis=-1)
    hm_img = apply_mpl_cmap(hm, cmap)
    hm_img = cv2.resize(hm_img, (base.shape[1], base.shape[0]))
    return cv2.addWeighted(base, 1 - alpha, hm_img, alpha, 0)


def make_image_grid(images: Sequence[np.ndarray], ncols: int = 4,
                    pad: int = 2) -> np.ndarray:
    """Tile images into a grid, `pad` black pixels between them."""
    images = [_denormalize(np.asarray(x)) for x in images]
    h = max(x.shape[0] for x in images)
    w = max(x.shape[1] for x in images)
    ncols = min(ncols, len(images))
    nrows = (len(images) + ncols - 1) // ncols
    grid = np.zeros((nrows * (h + pad) - pad, ncols * (w + pad) - pad, 3), np.uint8)
    for i, img in enumerate(images):
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        r, c = divmod(i, ncols)
        grid[r * (h + pad): r * (h + pad) + img.shape[0],
             c * (w + pad): c * (w + pad) + img.shape[1]] = img
    return grid


def convert_bboxes_to_wandb(
    boxes, labels=None, scores=None,
    class_names: Optional[Sequence[str]] = None,
    normalized_boxes: bool = True,
) -> dict:
    """xyxy boxes -> the W&B bounding-box overlay schema, to pass as
    wandb.Image(img, boxes={'predictions': <this>}); a plain dict, so the
    wandb package is not needed here."""
    box_data = []
    boxes = np.asarray(boxes, float).reshape(-1, 4)
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        entry = {
            "position": {"minX": float(x1), "minY": float(y1),
                         "maxX": float(x2), "maxY": float(y2)},
            "domain": "pixel" if not normalized_boxes else None,
            "class_id": int(labels[i]) if labels is not None else 0,
        }
        if entry["domain"] is None:
            entry.pop("domain")
        if scores is not None:
            entry["scores"] = {"confidence": float(scores[i])}
        if class_names is not None and labels is not None:
            entry["box_caption"] = class_names[int(labels[i])]
        box_data.append(entry)
    out = {"box_data": box_data}
    if class_names is not None:
        out["class_labels"] = {i: n for i, n in enumerate(class_names)}
    return out


def render_heatmap_diagnostic(images: np.ndarray, target_heatmaps: np.ndarray,
                              pred_heatmaps: Optional[np.ndarray] = None,
                              max_images: int = 8) -> np.ndarray:
    """Target (and optionally predicted) heatmap overlays tiled into one
    grid image: the Trainer's fit-start diagnostic, logged through
    MetricLogger.log_image."""
    tiles = []
    n = min(len(images), max_images)
    for i in range(n):
        tiles.append(draw_heatmap(images[i], target_heatmaps[i]))
        if pred_heatmaps is not None:
            tiles.append(draw_heatmap(images[i], pred_heatmaps[i]))
    return make_image_grid(tiles, ncols=2 if pred_heatmaps is not None else 4)
