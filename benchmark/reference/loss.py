"""CenterNet's training loss, in float32 (the upstream recipe:
CornerNet focal loss on the heatmap, GIoU on the boxes of the 3x3
neighbourhood of each centre).

Targets, from padded boxes (N, K, 4) xywh in input pixels, labels (N, K)
and a 0/1 mask (N, K):
  - feature-map box = box / stride; centre = round-half-even(x + w/2,
    y + h/2);
  - CornerNet's radius (min overlap 0.3), rounded, at least 0, the same on
    both axes; gaussian std r/3 + 1/6, kept where |dx| <= r, |dy| <= r and
    it is at least float32 eps; per class the max over boxes;
  - focal loss (alpha 2, beta 4) summed over every map value, over
    max(1, number of valid boxes);
  - box samples: the S x S pixels about each centre that fall on the map;
    each decodes a box as the decode does (pixel centre, exp offsets times
    the multiplier, clamped at 0, times the stride) against the target
    box xyxy; GIoU loss summed over the samples, over max(1, samples);
  - total = heatmap weight x focal + box weight x GIoU.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

EPS32 = float(torch.finfo(torch.float32).eps)


def cornernet_radius(w, h, min_overlap=0.3):
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(b1 * b1 - 4.0 * c1)) / 2.0
    b2 = 2.0 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt(b2 * b2 - 16.0 * c2)) / 8.0
    a3 = 4.0 * min_overlap
    b3 = -2.0 * min_overlap * (h + w)
    c3 = (min_overlap - 1.0) * w * h
    r3 = (b3 + torch.sqrt(b3 * b3 - 4.0 * a3 * c3)) / (2.0 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def target_heatmap(boxes, labels, mask, num_classes, h, w, stride):
    """(N, H, W, C) float32, looped over the box slots."""
    n, k = boxes.shape[:2]
    fm = boxes.float() / stride
    cx = torch.round(fm[..., 0] + fm[..., 2] / 2)
    cy = torch.round(fm[..., 1] + fm[..., 3] / 2)
    r = torch.clamp(torch.round(cornernet_radius(fm[..., 2], fm[..., 3])), min=0)
    std = r / 3 + 1 / 6
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device).view(1, h, 1)
    heat = torch.zeros((n, num_classes, h, w), device=boxes.device)
    rows = torch.arange(n, device=boxes.device)
    for j in range(k):
        dx = xs - cx[:, j].view(n, 1, 1)
        dy = ys - cy[:, j].view(n, 1, 1)
        s = std[:, j].view(n, 1, 1)
        g = torch.exp(-(dx * dx + dy * dy) / (2 * s * s))
        rr = r[:, j].view(n, 1, 1)
        keep = (dx.abs() <= rr) & (dy.abs() <= rr) & (g >= EPS32) \
            & (mask[:, j] > 0).view(n, 1, 1)
        g = torch.where(keep, g, torch.zeros_like(g))
        lab = labels[:, j].long()
        heat[rows, lab] = torch.maximum(heat[rows, lab], g)
    return heat.permute(0, 2, 3, 1)


def focal(logits, target, alpha=2.0, beta=4.0):
    pos = (target == 1.0).float()
    neg = torch.pow(1.0 - target, beta)
    p = torch.sigmoid(logits)
    return (-torch.pow(1 - p, alpha) * F.logsigmoid(logits) * pos
            - torch.pow(p, alpha) * F.logsigmoid(-logits) * neg)


def giou(pred, target, eps=1e-8):
    area_p = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    area_t = (target[..., 2] - target[..., 0]) * (target[..., 3] - target[..., 1])
    iw = torch.minimum(pred[..., 2], target[..., 2]) - torch.maximum(pred[..., 0], target[..., 0])
    ih = torch.minimum(pred[..., 3], target[..., 3]) - torch.maximum(pred[..., 1], target[..., 1])
    inter = torch.maximum(iw, torch.zeros_like(iw)) * torch.maximum(ih, torch.zeros_like(ih))
    union = area_p + area_t - inter
    iou = inter / (union + eps)
    ex = torch.maximum(pred[..., 2], target[..., 2]) - torch.minimum(pred[..., 0], target[..., 0])
    ey = torch.maximum(pred[..., 3], target[..., 3]) - torch.minimum(pred[..., 1], target[..., 1])
    return 1.0 - (iou - (1.0 - union / (ex * ey)))


def detection_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   model_cfg: Dict, stride: int, sample: int = 3) -> Dict[str, torch.Tensor]:
    heat = outputs["heatmap"].float()
    n, h, w, c = heat.shape
    boxes = batch["boxes"].float()
    mask = batch["mask"].float()
    tgt = target_heatmap(boxes, batch["labels"], mask, c, h, w, stride)
    hm = focal(heat, tgt).sum() / torch.clamp(mask.sum(), min=1.0)

    cx = torch.round(boxes[..., 0] / stride + boxes[..., 2] / (2.0 * stride)).long()
    cy = torch.round(boxes[..., 1] / stride + boxes[..., 3] / (2.0 * stride)).long()
    off = torch.arange(sample, device=boxes.device) - sample // 2
    sx = (cx[..., None, None] + off.view(1, 1, -1, 1)).expand(-1, -1, sample, sample)
    sy = (cy[..., None, None] + off.view(1, 1, 1, -1)).expand(-1, -1, sample, sample)
    valid = ((sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
             & (mask[..., None, None] > 0)).float()
    idx = (sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1)).reshape(n, -1)
    raw = outputs["box_2d"].float().reshape(n, h * w, 4)
    o = torch.gather(raw, 1, idx[..., None].expand(-1, -1, 4))
    if model_cfg.get("box_log", False):
        o = torch.exp(o)
    o = torch.maximum(o * model_cfg.get("box_multiplier", 1.0), torch.zeros_like(o))
    pcx = (idx % w).float() + 0.5
    pcy = torch.div(idx, w, rounding_mode="floor").float() + 0.5
    pred = torch.stack([pcx - o[..., 0], pcy - o[..., 1],
                        pcx + o[..., 2], pcy + o[..., 3]], dim=-1) * stride
    xyxy = torch.cat([boxes[..., :2], boxes[..., :2] + boxes[..., 2:]], dim=-1)
    tgt_box = xyxy[:, :, None, :].expand(-1, -1, sample * sample, 4).reshape(n, -1, 4)
    vmask = valid.reshape(n, -1)
    if model_cfg.get("box_loss", "GIoULoss") != "GIoULoss":
        raise ValueError("the reference loss has GIoU boxes only")
    bl = (giou(pred, tgt_box) * vmask).sum() / torch.clamp(vmask.sum(), min=1.0)
    total = hm * model_cfg.get("heatmap_loss_weight", 1.0) \
        + bl * model_cfg.get("box_loss_weight", 1.0)
    return {"heatmap": hm, "box_2d": bl, "total": total}
