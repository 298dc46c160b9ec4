"""Numpy box utilities for the host-side tracker (a copy of the JAX
package's utils/box_np.py, which the port may not import).

Format conversion and pairwise IoU/GIoU (distance) matrices used as the
tracker's association costs.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "convert_box_format",
    "box_inter_union_matrix",
    "box_iou_matrix",
    "box_giou_matrix",
    "box_iou_distance_matrix",
    "box_giou_distance_matrix",
    "xyxy_to_xyah",
    "xyah_to_xyxy",
]

_FORMATS = ("xyxy", "xywh", "cxcywh")


def convert_box_format(boxes, src: str, dst: str):
    """xyxy/xywh/cxcywh conversion on numpy arrays (last dim 4)."""
    assert src in _FORMATS and dst in _FORMATS
    boxes = np.asarray(boxes, np.float64)
    if src == dst:
        return boxes.copy()
    out = boxes.copy()
    if src == "xywh":
        out[..., 2:] = boxes[..., :2] + boxes[..., 2:]
    elif src == "cxcywh":
        out[..., :2] = boxes[..., :2] - boxes[..., 2:] / 2
        out[..., 2:] = boxes[..., :2] + boxes[..., 2:] / 2
    # out is xyxy
    if dst == "xyxy":
        return out
    res = out.copy()
    if dst == "xywh":
        res[..., 2:] = out[..., 2:] - out[..., :2]
    else:  # cxcywh
        res[..., :2] = (out[..., :2] + out[..., 2:]) / 2
        res[..., 2:] = out[..., 2:] - out[..., :2]
    return res


def box_inter_union_matrix(boxes1, boxes2):
    """Pairwise intersection/union of xyxy boxes: (N,4) x (M,4) -> (N,M)."""
    boxes1 = np.asarray(boxes1, np.float64)
    boxes2 = np.asarray(boxes2, np.float64)
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    x1 = np.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    y1 = np.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    x2 = np.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    y2 = np.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    union = area1[:, None] + area2[None, :] - inter
    return inter, union


def box_iou_matrix(boxes1, boxes2, eps: float = 1e-8):
    inter, union = box_inter_union_matrix(boxes1, boxes2)
    return inter / (union + eps)


def box_giou_matrix(boxes1, boxes2, eps: float = 1e-8):
    boxes1 = np.asarray(boxes1, np.float64)
    boxes2 = np.asarray(boxes2, np.float64)
    inter, union = box_inter_union_matrix(boxes1, boxes2)
    iou = inter / (union + eps)
    x1 = np.minimum(boxes1[:, None, 0], boxes2[None, :, 0])
    y1 = np.minimum(boxes1[:, None, 1], boxes2[None, :, 1])
    x2 = np.maximum(boxes1[:, None, 2], boxes2[None, :, 2])
    y2 = np.maximum(boxes1[:, None, 3], boxes2[None, :, 3])
    enclosing = (x2 - x1) * (y2 - y1)
    return iou - (enclosing - union) / (enclosing + eps)


def box_iou_distance_matrix(boxes1, boxes2):
    """1 - IoU (reference utils/box.py:83-87)."""
    return 1.0 - box_iou_matrix(boxes1, boxes2)


def box_giou_distance_matrix(boxes1, boxes2):
    """(1 - GIoU) / 2, mapped to [0, 1] (reference utils/box.py:89-92)."""
    return (1.0 - box_giou_matrix(boxes1, boxes2)) / 2.0


def xyxy_to_xyah(box):
    """xyxy -> (center x, center y, aspect w/h, height) — the measurement
    space of the reference's alternative Kalman parameterization
    (reference models/tracker.py:203-215)."""
    box = np.asarray(box, float).copy()
    wh = box[..., 2:4] - box[..., 0:2]
    out = np.empty_like(box)
    out[..., 0:2] = box[..., 0:2] + wh / 2
    out[..., 2] = wh[..., 0] / np.maximum(wh[..., 1], 1e-12)
    out[..., 3] = wh[..., 1]
    return out


def xyah_to_xyxy(box):
    """Inverse of xyxy_to_xyah (reference models/tracker.py:210-215)."""
    box = np.asarray(box, float).copy()
    h = box[..., 3]
    w = box[..., 2] * h
    out = np.empty_like(box)
    out[..., 0] = box[..., 0] - w / 2
    out[..., 1] = box[..., 1] - h / 2
    out[..., 2] = out[..., 0] + w
    out[..., 3] = out[..., 1] + h
    return out
