"""Detection decode in plain PyTorch (port of ops/decode.py).

  1. 3x3 max-pool equality mask (pseudo-NMS)
  2. per-pixel class max / first-index argmax
  3. flatten H*W, top-k scores, gather labels
  4. gather box offsets at the indices and decode: cx = idx % W + 0.5,
     cy = idx // W + 0.5, offsets -> optional exp -> * multiplier ->
     clamp >= 0, box = (cx-l, cy-t, cx+r, cy+b) * stride (or normalised)

Maps are NHWC and indices flatten H*W as idx = y*W + x, as in the JAX
package. `decode_detections_auto` sends CUDA maps to the fused peak kernel
(`peak_decode.decode_detections_fused`) and everything else here.

Top-k ties: `torch.topk` does not promise an order among equal scores
(`lax.top_k` puts the lower index first). The port's convention is that
the returned scores are the same sorted values; among entries with equal
scores the indices, labels and boxes may come in any order, and where
equal scores straddle the k-th place any of them may be kept.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

__all__ = [
    "peak_class_scores",
    "get_topk_from_heatmap",
    "gather_and_decode_boxes",
    "gather_at_indices",
    "decode_detections",
    "decode_detections_auto",
]

NEG_BIG = -1e30  # below any real logit: what a suppressed logit becomes


def decode_detections_auto(*args, **kwargs):
    """decode_detections, through the fused peak kernel for CUDA maps with
    the default 3x3 pseudo-NMS, and the plain path otherwise."""
    heatmap = args[0] if args else kwargs["heatmap"]
    if (heatmap.is_cuda and kwargs.get("nms_kernel", 3) == 3
            and kwargs.get("pseudo_nms", True)):
        from .peak_decode import decode_detections_fused

        kwargs.pop("pseudo_nms", None)  # the fused kernel always suppresses
        return decode_detections_fused(*args, **kwargs)
    return decode_detections(*args, **kwargs)


def peak_class_scores(
    heatmap: torch.Tensor, nms_kernel: int = 3, pseudo_nms: bool = True,
    from_logits: bool = False,
):
    """Suppress non-peaks and reduce classes. heatmap: (N, H, W, C)
    probabilities, or logits with from_logits=True (sigmoid is monotonic,
    so mask, argmax and order are the same).

    Returns (scores, labels), each (N, H*W).
    """
    n, h, w, _ = heatmap.shape
    if pseudo_nms:
        pad = (nms_kernel - 1) // 2
        # max_pool2d pads with -inf, as reduce_window does
        pooled = F.max_pool2d(heatmap.permute(0, 3, 1, 2), nms_kernel,
                              stride=1, padding=pad).permute(0, 2, 3, 1)
        if from_logits:
            heatmap = torch.where(pooled == heatmap, heatmap,
                                  heatmap.new_tensor(NEG_BIG))
        else:  # a product would keep a NaN (NaN * 0): select, as XLA does
            heatmap = torch.where(pooled == heatmap, heatmap,
                                  heatmap.new_tensor(0.0))
    scores, labels = heatmap.max(dim=-1)  # first index of the max
    return scores.reshape(n, h * w), labels.to(torch.int32).reshape(n, h * w)


def get_topk_from_heatmap(
    heatmap: torch.Tensor,
    num_detections: int = 100,
    nms_kernel: int = 3,
    pseudo_nms: bool = True,
    from_logits: bool = False,
):
    """Top-k detections from an (N, H, W, C) heatmap.

    Returns (scores, indices, labels), each (N, k); k is clamped to H*W.
    """
    scores, labels = peak_class_scores(heatmap, nms_kernel, pseudo_nms,
                                       from_logits=from_logits)
    return _topk(scores, labels, num_detections, from_logits)


def _topk(scores, labels, num_detections: int, from_logits: bool):
    k = min(num_detections, scores.shape[-1])
    topk_scores, topk_indices = torch.topk(scores, k, dim=-1)
    topk_labels = torch.gather(labels, 1, topk_indices)
    topk_scores = topk_scores.float()
    if from_logits:
        topk_scores = torch.sigmoid(topk_scores)
    return topk_scores, topk_indices.to(torch.int32), topk_labels


def gather_and_decode_boxes(
    box_offsets: torch.Tensor,   # (N, H, W, 4) NHWC
    indices: torch.Tensor,       # (N, k) flattened y*W + x
    normalize_boxes: bool = False,
    box_log: bool = False,
    box_multiplier: float = 1.0,
    stride: int = 4,
) -> torch.Tensor:
    """Gather (l, t, r, b) offsets at indices and decode to xyxy (N, k, 4).

    The k offsets are gathered first and widened to f32, then transformed.
    """
    n, h, w, _ = box_offsets.shape
    idx = indices.long()
    cx = (idx % w).float() + 0.5
    cy = torch.div(idx, w, rounding_mode="floor").float() + 0.5
    flat = box_offsets.reshape(n, h * w, 4)
    offsets = torch.gather(flat, 1, idx[..., None].expand(n, idx.shape[1], 4))
    offsets = offsets.float()
    if box_log:
        offsets = torch.exp(offsets)
    # maximum, not clamp: at exactly 0 it passes half the gradient, as
    # jnp.clip does (clamp passes all of it)
    offsets = offsets * box_multiplier
    offsets = torch.maximum(offsets, torch.zeros_like(offsets))

    x1, y1 = cx - offsets[..., 0], cy - offsets[..., 1]
    x2, y2 = cx + offsets[..., 2], cy + offsets[..., 3]
    if normalize_boxes:   # Python scalars: no H2D copy, which would sync
        return torch.stack([x1 / w, y1 / h, x2 / w, y2 / h], dim=-1)
    return torch.stack([x1, y1, x2, y2], dim=-1) * stride


def gather_at_indices(features: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
    """Gather (N, H, W, C) features at (N, k) flat indices -> (N, k, C)."""
    n, h, w, c = features.shape
    flat = features.reshape(n, h * w, c)
    idx = indices.long()[..., None].expand(n, indices.shape[1], c)
    return torch.gather(flat, 1, idx)


def assemble_detections(scores, indices, labels, box_offsets,
                        reid=None, normalize_boxes: bool = False,
                        box_log: bool = False, box_multiplier: float = 1.0,
                        stride: int = 4) -> Dict[str, torch.Tensor]:
    """Top-k results + box gather -> the decode's output dict."""
    boxes = gather_and_decode_boxes(
        box_offsets, indices, normalize_boxes=normalize_boxes,
        box_log=box_log, box_multiplier=box_multiplier, stride=stride)
    out = {"boxes": boxes, "scores": scores, "labels": labels}
    if reid is not None:
        out["embeddings"] = gather_at_indices(reid, indices).float()
    return out


def decode_detections(
    heatmap: torch.Tensor,        # (N, H, W, C) probabilities (or logits)
    box_offsets: torch.Tensor,    # (N, H, W, 4)
    reid: Optional[torch.Tensor] = None,   # (N, H, W, E)
    num_detections: int = 100,
    nms_kernel: int = 3,
    normalize_boxes: bool = False,
    box_log: bool = False,
    box_multiplier: float = 1.0,
    stride: int = 4,
    from_logits: bool = False,
    pseudo_nms: bool = True,
) -> Dict[str, torch.Tensor]:
    """Full decode -> {boxes (xyxy), scores, labels [, embeddings]}.

    Takes the model's own dtypes (bf16 included); the heatmap is widened
    to f32 first, and scores, boxes and embeddings come back f32.
    """
    scores, indices, labels = get_topk_from_heatmap(
        heatmap.float(), num_detections=num_detections,
        nms_kernel=nms_kernel, pseudo_nms=pseudo_nms, from_logits=from_logits)
    return assemble_detections(
        scores, indices, labels, box_offsets, reid=reid,
        normalize_boxes=normalize_boxes, box_log=box_log,
        box_multiplier=box_multiplier, stride=stride)
