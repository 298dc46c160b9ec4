"""CenterNet's decode from the maps, in float32: sigmoid scores, a 3x3
peak test (a pixel keeps a class score only where it equals the 3x3 max
of that class, -inf outside the map), the best class a pixel, the top
`k` pixels, and boxes from the (l, t, r, b) offsets: exp, times the
multiplier, clamped at 0, about the pixel's centre (x + 0.5, y + 0.5),
times the stride (or over the map's size, normalised).

`dense` returns what the comparison needs besides: every pixel's class
scores, the largest of each class's scores in the pixel's 3x3 window
(a score passes the peak test where it equals it), and the box each pixel
decodes to."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def pixel_boxes(box: torch.Tensor, box_log: bool, multiplier: float,
                stride: int, normalize: bool) -> torch.Tensor:
    """(N, H, W, 4) offsets -> (N, H*W, 4) xyxy boxes of every pixel."""
    n, h, w, _ = box.shape
    off = box.float()
    if box_log:
        off = torch.exp(off)
    off = (off * multiplier).clamp(min=0).reshape(n, h * w, 4)
    ys, xs = torch.meshgrid(torch.arange(h, device=box.device),
                            torch.arange(w, device=box.device), indexing="ij")
    cx = xs.reshape(1, -1).float() + 0.5
    cy = ys.reshape(1, -1).float() + 0.5
    xyxy = torch.stack([cx - off[..., 0], cy - off[..., 1],
                        cx + off[..., 2], cy + off[..., 3]], dim=-1)
    if normalize:
        return xyxy / torch.tensor([w, h, w, h], dtype=torch.float32,
                                   device=box.device)
    return xyxy * stride


def dense(heatmap: torch.Tensor, box: torch.Tensor, k: int, box_log: bool,
          multiplier: float, stride: int, normalize: bool) -> Dict[str, torch.Tensor]:
    """heatmap (N, H, W, C) logits. Returns {scores (N, H*W, C) sigmoid,
    window_max (N, H*W, C) sigmoid, boxes (N, H*W, 4), top_scores (N, k)
    descending}."""
    n, h, w, c = heatmap.shape
    logits = heatmap.float()
    pooled = F.max_pool2d(logits.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)
    probs = torch.sigmoid(logits)
    peaks = torch.where(pooled == logits, probs, torch.zeros_like(probs))
    best = peaks.reshape(n, h * w, c).amax(dim=-1)
    top = torch.topk(best, min(k, h * w), dim=-1).values
    return {"scores": probs.reshape(n, h * w, c),
            "window_max": torch.sigmoid(pooled).reshape(n, h * w, c),
            "boxes": pixel_boxes(box, box_log, multiplier, stride, normalize),
            "top_scores": top}
