"""Device-side inference preprocessing (port of ops/preprocess.py).

uint8 NHWC batches go to the device as they are; the float conversion,
optional bilinear resize and ImageNet normalisation run there.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "preprocess"]


def preprocess(
    images: torch.Tensor,
    size: Optional[Tuple[int, int]] = None,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> normalised float (N, size_h, size_w, 3), NHWC.

    Bilinear resize with half-pixel centres, then (x - 255*mean) / (255*std);
    mean and std are sequences or tensors of 3.
    `jax.image.resize` antialiases when it downscales; `F.interpolate` does
    so only with `antialias=True`, which is passed on a downscale.
    """
    x = images.to(dtype)
    if size is not None and tuple(size) != tuple(images.shape[1:3]):
        downscale = size[0] < images.shape[1] or size[1] < images.shape[2]
        x = F.interpolate(
            x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
            align_corners=False, antialias=downscale,
        ).permute(0, 2, 3, 1)
    # mean and std may already be tensors on the device (the predictor
    # keeps them there): a list makes an H2D copy, which waits for the card
    mean_t = torch.as_tensor(mean, dtype=dtype, device=x.device) * 255.0
    std_t = torch.as_tensor(std, dtype=dtype, device=x.device) * 255.0
    return (x - mean_t) / std_t
