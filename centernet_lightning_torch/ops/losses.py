"""Detection and ReID losses (port of ops/losses.py).

Every loss returns the per-element loss with no reduction; `reduce_loss`
applies a 0/1 weight mask (the padded-batch contract) and reduces. The
registries keep the reference's class names and the Gen-A aliases, so a
config names a loss the same way for either package. Box losses take xyxy
boxes and keep a trailing dim of 1 (IoU family) or 4 (L1), so both
broadcast against the same (..., 1) weights.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .boxes import box_inter_union, enclosing_box

__all__ = ["reduce_loss", "cornernet_focal_loss", "quality_focal_loss",
           "l1_loss", "smooth_l1_loss", "iou_loss", "giou_loss", "diou_loss",
           "ciou_loss", "reid_cross_entropy_loss", "reid_triplet_loss",
           "get_heatmap_loss", "get_box_loss"]


def reduce_loss(loss: torch.Tensor, reduction: str = "none",
                weights: Optional[torch.Tensor] = None,
                norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multiply by `weights` (broadcast), then reduce ("none", "sum" or
    "mean", the mean over the weights' sum when given), then divide by
    `norm`."""
    if weights is not None:
        loss = loss * weights
    if reduction == "none":
        return loss
    total = loss.sum()
    if reduction == "mean":
        denom = weights.sum() if weights is not None else loss.numel()
        total = total / torch.clamp(torch.as_tensor(denom, dtype=total.dtype,
                                                     device=total.device), min=1)
    if norm is not None:
        total = total / norm
    return total


# ---- heatmap losses, on logits ------------------------------------------

def cornernet_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                         alpha: float = 2.0, beta: float = 4.0) -> torch.Tensor:
    """CornerNet focal loss: positives where the target is exactly 1,
    negatives weighted by (1 - t)^beta; log-sigmoid for stability."""
    pos_weight = (targets == 1.0).to(logits.dtype)
    neg_weight = torch.pow(1.0 - targets, beta)
    probs = torch.sigmoid(logits)
    pos_loss = -torch.pow(1.0 - probs, alpha) * F.logsigmoid(logits) * pos_weight
    neg_loss = -torch.pow(probs, alpha) * F.logsigmoid(-logits) * neg_weight
    return pos_loss + neg_loss


def quality_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       beta: float = 2.0) -> torch.Tensor:
    """Quality focal loss (Generalized Focal Loss).

    At a logit of exactly 0 the gradient is JAX's: `jnp.maximum(x, 0)`
    passes half (torch.maximum, not clamp, which passes all of it) and
    `jnp.abs` takes the x >= 0 side (torch.abs would pass none)."""
    probs = torch.sigmoid(logits)
    relu = torch.maximum(logits, torch.zeros_like(logits))
    magnitude = torch.where(logits >= 0, logits, -logits)
    ce = relu - logits * targets + torch.log1p(torch.exp(-magnitude))
    return torch.pow(torch.abs(targets - probs), beta) * ce


# ---- box losses, xyxy ---------------------------------------------------

def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0) -> torch.Tensor:
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _iou(pred, target, eps):
    inter, union = box_inter_union(pred, target)
    return inter / (union + eps), union


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             eps: float = 1e-8) -> torch.Tensor:
    iou, _ = _iou(pred, target, eps)
    return (1.0 - iou)[..., None]


def giou_loss(pred: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-8) -> torch.Tensor:
    iou, union = _iou(pred, target, eps)
    x1, y1, x2, y2 = enclosing_box(pred, target)
    enclosing = (x2 - x1) * (y2 - y1)
    giou = iou - (1.0 - union / enclosing)
    return (1.0 - giou)[..., None]


def _center_distance_penalty(pred, target):
    x1, y1, x2, y2 = enclosing_box(pred, target)
    diagonal_sq = torch.square(x2 - x1) + torch.square(y2 - y1)
    c1 = (pred[..., :2] + pred[..., 2:]) / 2
    c2 = (target[..., :2] + target[..., 2:]) / 2
    distance_sq = (torch.square(c2[..., 0] - c1[..., 0])
                   + torch.square(c2[..., 1] - c1[..., 1]))
    return distance_sq / diagonal_sq


def diou_loss(pred: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-8) -> torch.Tensor:
    iou, _ = _iou(pred, target, eps)
    return (1.0 - iou + _center_distance_penalty(pred, target))[..., None]


def ciou_loss(pred: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-8) -> torch.Tensor:
    iou, _ = _iou(pred, target, eps)
    dist = _center_distance_penalty(pred, target)
    w1 = pred[..., 2] - pred[..., 0]
    h1 = pred[..., 3] - pred[..., 1]
    w2 = target[..., 2] - target[..., 0]
    h2 = target[..., 3] - target[..., 1]
    angle_diff = (torch.atan(w1 / (h1 + eps))
                  - torch.atan(w2 / (h2 + eps))) * 2.0 / math.pi
    v = torch.square(angle_diff)
    alpha = v / (1.0 - iou + v + eps)
    return (1.0 - iou + dist + alpha * v)[..., None]


# ---- ReID losses ----------------------------------------------------------

def reid_cross_entropy_loss(logits: torch.Tensor, ids: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            eps: float = 1e-8) -> torch.Tensor:
    """Masked identity cross-entropy over (M, num_ids) logits: the mean
    over the rows whose mask is set (sum / (mask sum + eps))."""
    log_probs = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(log_probs, 1, ids.long()[:, None])[:, 0]
    if mask is None:
        return ce.mean()
    mask = mask.to(ce.dtype)
    return (ce * mask).sum() / (mask.sum() + eps)


def reid_triplet_loss(embeddings: torch.Tensor, ids: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      margin: float = 0.05) -> torch.Tensor:
    """Triplet margin loss on cosine similarity, with pytorch-metric-
    learning's semantics: every valid triplet (a, p, n) with ids[a] ==
    ids[p], a != p and ids[a] != ids[n], each relu(sim(a, n) - sim(a, p)
    + margin), averaged over the violating (nonzero) ones; 0 when none
    violates.

    Runs over the (anchor, positive) pairs in chunks of M, each against
    all M candidates: memory stays O(M^2), never the (M, M, M) tensor.
    """
    e = embeddings / (torch.linalg.vector_norm(embeddings, dim=-1,
                                               keepdim=True) + 1e-12)
    s = (e @ e.T).float()                                   # (M, M)
    m = ids.shape[0]
    valid = (torch.ones(m, dtype=torch.bool, device=ids.device)
             if mask is None else mask.bool())
    pair_ok = valid[None, :] & valid[:, None]
    same = (ids[:, None] == ids[None, :]) & pair_ok
    eye = torch.eye(m, dtype=torch.bool, device=ids.device)
    neg_mask = ~same & pair_ok
    anchors, positives = torch.nonzero(same & ~eye, as_tuple=True)
    total = s.new_zeros(())
    count = s.new_zeros(())
    for start in range(0, anchors.numel(), max(m, 1)):
        a = anchors[start:start + m]
        p = positives[start:start + m]
        loss = s[a] - s[a, p][:, None] + margin             # (pairs, M)
        hit = (loss > 0) & neg_mask[a]
        total = total + torch.where(hit, loss, torch.zeros_like(loss)).sum()
        count = count + hit.sum()
    return total / torch.clamp(count, min=1.0)


_HEATMAP_LOSSES = {
    "CornerNetFocalLoss": cornernet_focal_loss,
    "QualityFocalLoss": quality_focal_loss,
    "cornernet_focal": cornernet_focal_loss,
    "quality_focal": quality_focal_loss,
}

_BOX_LOSSES = {
    "L1Loss": l1_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "IoULoss": iou_loss,
    "GIoULoss": giou_loss,
    "DIoULoss": diou_loss,
    "CIoULoss": ciou_loss,
    "l1": l1_loss,
    "smooth_l1": smooth_l1_loss,
    "iou": iou_loss,
    "giou": giou_loss,
    "diou": diou_loss,
    "ciou": ciou_loss,
}


def get_heatmap_loss(name: str, **kwargs) -> Callable:
    fn = _HEATMAP_LOSSES[name]
    return partial(fn, **kwargs) if kwargs else fn


def get_box_loss(name: str, **kwargs) -> Callable:
    fn = _BOX_LOSSES[name]
    return partial(fn, **kwargs) if kwargs else fn
