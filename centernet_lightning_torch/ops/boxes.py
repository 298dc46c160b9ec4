"""Box geometry, elementwise over leading dims (port of ops/boxes.py).

Boxes are float tensors whose last dim is 4. The IoU helpers take xyxy
boxes and, like the reference loss layer, do not clamp degenerate ones.
"""
from __future__ import annotations

import torch

__all__ = ["convert_box_format", "area", "box_inter_union", "box_iou",
           "enclosing_box"]

_FORMATS = ("xyxy", "xywh", "cxcywh")


def convert_box_format(boxes: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """Convert between the xyxy, xywh and cxcywh formats."""
    if src not in _FORMATS or dst not in _FORMATS:
        raise ValueError(f"box formats must be among {_FORMATS}, "
                         f"got {src!r} -> {dst!r}")
    if src == dst:
        return boxes
    if src == "xywh":
        x, y, w, h = boxes.unbind(-1)
        boxes = torch.stack([x, y, x + w, y + h], dim=-1)
    elif src == "cxcywh":
        cx, cy, w, h = boxes.unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            dim=-1)
    if dst == "xyxy":
        return boxes
    x1, y1, x2, y2 = boxes.unbind(-1)
    if dst == "xywh":
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, shape (...)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_inter_union(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise intersection and union of xyxy boxes."""
    area1 = area(boxes1)
    area2 = area(boxes2)
    x1 = torch.maximum(boxes1[..., 0], boxes2[..., 0])
    y1 = torch.maximum(boxes1[..., 1], boxes2[..., 1])
    x2 = torch.minimum(boxes1[..., 2], boxes2[..., 2])
    y2 = torch.minimum(boxes1[..., 3], boxes2[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    return inter, area1 + area2 - inter


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
            eps: float = 1e-8) -> torch.Tensor:
    inter, union = box_inter_union(boxes1, boxes2)
    return inter / (union + eps)


def enclosing_box(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Corners (x1, y1, x2, y2) of the smallest xyxy box enclosing both."""
    return (torch.minimum(boxes1[..., 0], boxes2[..., 0]),
            torch.minimum(boxes1[..., 1], boxes2[..., 1]),
            torch.maximum(boxes1[..., 2], boxes2[..., 2]),
            torch.maximum(boxes1[..., 3], boxes2[..., 3]))
