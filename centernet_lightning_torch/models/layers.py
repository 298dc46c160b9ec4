"""Shared building blocks (port of models/layers.py: ConvNormAct, Upsample).

Modules take and return NCHW tensors; the model keeps them in
`torch.channels_last` memory format, so a convolution reads and writes the
same bytes as the JAX package's NHWC layout.

BatchNorm keeps flax's settings: eps 1e-5, and flax `momentum=0.9` (weight
of the running value) is torch `momentum=0.1` (weight of the new batch).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ConvNormAct", "Upsample", "CONV_BLOCKS", "get_conv_block",
           "batch_norm"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvNormAct(nn.Module):
    """Conv -> BatchNorm -> activation, padding "SAME" (odd kernels).

    Parameters: `conv` (bias only without norm) and `bn`, the flax
    `Conv_0` and `BatchNorm_0` of the same block.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, groups: int = 1,
                 act: Optional[Callable] = F.relu, use_norm: bool = True):
        super().__init__()
        if kernel_size % 2 == 0:
            raise NotImplementedError(
                "ConvNormAct: even kernels need flax's asymmetric SAME "
                "padding; no block on the serving path uses one")
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=kernel_size // 2,
                              groups=groups, bias=not use_norm)
        self.bn = batch_norm(out_channels) if use_norm else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class Upsample(nn.Module):
    """x2 upsample: nearest or bilinear (half-pixel centres, as
    `jax.image.resize`). The conv_transpose form carries weights and waits
    for the slice that ports the remaining necks and blocks."""

    def __init__(self, method: str = "nearest"):
        super().__init__()
        if method == "conv_transpose":
            raise NotImplementedError(
                "Upsample(method='conv_transpose') is ported with the "
                "remaining necks and blocks (ROADMAP Queue 1 item 8)")
        if method not in ("nearest", "bilinear"):
            raise ValueError(f"unknown upsample method {method!r}")
        self.method = method

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "nearest":
            return F.interpolate(x, scale_factor=2, mode="nearest")
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)


CONV_BLOCKS = {"normal": ConvNormAct}

_LATER_BLOCKS = {
    "separable": "the remaining necks and blocks (ROADMAP Queue 1 item 8)",
    "dcn": "the DCN slice (ROADMAP Queue 1 item 9)",
    "deformable": "the DCN slice (ROADMAP Queue 1 item 9)",
}


def get_conv_block(name: str):
    if name in CONV_BLOCKS:
        return CONV_BLOCKS[name]
    if name in _LATER_BLOCKS or name.startswith(("dcn_fast", "dcn_fused")):
        raise NotImplementedError(
            f"conv block {name!r} is ported with "
            f"{_LATER_BLOCKS.get(name, _LATER_BLOCKS['dcn'])}")
    raise KeyError(f"unknown conv block {name!r}; available: "
                   f"{sorted(CONV_BLOCKS)}")
