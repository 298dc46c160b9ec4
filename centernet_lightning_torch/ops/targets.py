"""Training targets, vectorised over the padded box set (port of
ops/targets.py).

Batches follow the CollateDetection contract: boxes (N, K, 4) xywh in
input-image coordinates, labels (N, K), mask (N, K) with 0 on padded
slots. The numerical contract is the JAX package's:
  - feature-map boxes = boxes / stride; centres rounded half to even
    (`torch.round`, as `jnp.round`);
  - radius strategies fixed / ttfnet / cornernet; integer radii
    r = max(0, round(r)) and std = r/3 + 1/6;
  - gaussian exp(-(dx^2 / 2sx^2 + dy^2 / 2sy^2)) inside |dx| <= rx,
    |dy| <= ry, zero below float32 eps, merged per class by max;
  - S x S centre sampling for the box regression.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import torch

__all__ = ["fixed_radius", "ttfnet_radius", "cornernet_radius",
           "get_radius_fn", "render_heatmap", "center_sample_indices"]

_F32_EPS = float(torch.finfo(torch.float32).eps)


def fixed_radius(w: torch.Tensor, h: torch.Tensor, r: float = 1.0):
    rr = torch.full_like(w, r)
    return rr, rr


def ttfnet_radius(w: torch.Tensor, h: torch.Tensor, alpha: float = 0.54):
    return w / 2.0 * alpha, h / 2.0 * alpha


def cornernet_radius(w: torch.Tensor, h: torch.Tensor,
                     min_overlap: float = 0.3):
    """CornerNet's three-case quadratic radius (isotropic)."""
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

    r = torch.minimum(torch.minimum(r1, r2), r3)
    return r, r


_RADIUS_FNS = {"fixed": fixed_radius, "ttfnet": ttfnet_radius,
               "cornernet": cornernet_radius}


def get_radius_fn(name: str, **kwargs) -> Callable:
    fn = _RADIUS_FNS[name]
    return partial(fn, **kwargs) if kwargs else fn


def render_heatmap(boxes: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, num_classes: int, out_h: int,
                   out_w: int, stride: int, radius_fn: Callable) -> torch.Tensor:
    """Target heatmap (N, out_h, out_w, num_classes), f32.

    Each box's gaussian is scatter-maxed into its class plane. As with the
    JAX `.at[labels].max(g, mode="drop")`, a negative label counts from
    the end and a label past the classes is dropped, so padded slots never
    raise; their gaussians are zero anyway.
    """
    n, k = boxes.shape[:2]
    fm = boxes.float() / stride
    centers = torch.round(fm[..., :2] + fm[..., 2:] / 2.0)       # (N, K, 2)
    cx = centers[..., 0][..., None, None]
    cy = centers[..., 1][..., None, None]
    rx, ry = radius_fn(fm[..., 2], fm[..., 3])
    rx = torch.clamp(torch.round(rx), min=0.0)
    ry = torch.clamp(torch.round(ry), min=0.0)
    std_x = (rx / 3.0 + 1.0 / 6.0)[..., None, None]
    std_y = (ry / 3.0 + 1.0 / 6.0)[..., None, None]

    dev = boxes.device
    xs = torch.arange(out_w, dtype=torch.float32, device=dev).view(1, 1, 1, out_w)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev).view(1, 1, out_h, 1)
    dx = xs - cx                                                  # (N, K, 1, W)
    dy = ys - cy                                                  # (N, K, H, 1)
    g = torch.exp(-(dx * dx / (2.0 * std_x * std_x)
                    + dy * dy / (2.0 * std_y * std_y)))           # (N, K, H, W)
    keep = ((torch.abs(dx) <= rx[..., None, None])
            & (torch.abs(dy) <= ry[..., None, None])
            & mask.bool()[..., None, None] & (g >= _F32_EPS))
    g = torch.where(keep, g, torch.zeros_like(g))

    lab = labels.long()
    lab = torch.where(lab < 0, lab + num_classes, lab)
    # out-of-range labels go to a scratch plane that is cut off below
    lab = torch.where((lab >= 0) & (lab < num_classes), lab,
                      torch.full_like(lab, num_classes))
    heat = torch.zeros((n, num_classes + 1, out_h * out_w),
                       dtype=torch.float32, device=dev)
    heat.scatter_reduce_(1, lab[..., None].expand(n, k, out_h * out_w),
                         g.reshape(n, k, out_h * out_w), reduce="amax")
    return heat[:, :num_classes].reshape(
        n, num_classes, out_h, out_w).permute(0, 2, 3, 1)


def center_sample_indices(boxes: torch.Tensor, mask: torch.Tensor,
                          out_h: int, out_w: int, stride: int,
                          sample_size: int = 3
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat feature-map indices of the S x S neighbourhood of each centre.

    Returns (indices (N, K*S*S) int32 = cy*out_w + cx, clamped in bounds;
    sample_mask (N, K*S*S) f32, 1 for an in-bounds neighbour of a valid
    box, each sample tested on its own; target_xyxy (N, K*S*S, 4), the
    input-scale box repeated per sample). Samples run with cy fastest.
    """
    if sample_size < 1 or sample_size % 2 == 0:
        raise ValueError(f"sample_size must be odd and >= 1, got {sample_size}")
    boxes = boxes.float()
    centers = torch.round(boxes[..., :2] / stride + boxes[..., 2:] / (2.0 * stride))
    cx = centers[..., 0].to(torch.int32)
    cy = centers[..., 1].to(torch.int32)
    offs = torch.arange(sample_size, dtype=torch.int32, device=boxes.device) \
        - sample_size // 2
    sx = cx[..., None, None] + offs.view(1, 1, -1, 1)             # (N, K, S, 1)
    sy = cy[..., None, None] + offs.view(1, 1, 1, -1)             # (N, K, 1, S)
    sx, sy = torch.broadcast_tensors(sx, sy)                      # (N, K, S, S)

    in_bounds = (sx >= 0) & (sx <= out_w - 1) & (sy >= 0) & (sy <= out_h - 1)
    valid = in_bounds & mask.bool()[..., None, None]
    idx = sy.clamp(0, out_h - 1) * out_w + sx.clamp(0, out_w - 1)

    n, k = boxes.shape[:2]
    s2 = sample_size * sample_size
    target = torch.cat([boxes[..., :2], boxes[..., :2] + boxes[..., 2:]], dim=-1)
    target = target[:, :, None, :].expand(n, k, s2, 4)
    return (idx.reshape(n, k * s2).to(torch.int32),
            valid.reshape(n, k * s2).to(torch.float32),
            target.reshape(n, k * s2, 4))
