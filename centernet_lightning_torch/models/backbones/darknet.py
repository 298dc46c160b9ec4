"""CSPDarknet-53 (port of models/backbones/darknet.py): a 3x3 stem, then
five CSP stages, each a stride-2 DarkConv, a residual branch and a
shortcut branch of 1x1 DarkConvs, concatenated and fused; mish throughout
(YOLOv4). `forward` takes NCHW and returns the maps of stages 2-5 at
strides 4/8/16/32, widths `stage_filters[1:]`.

Names: flax `CSPStage_{i}` / `ResBlock_{i}` are `blocks.{i}` and
`DarkConv_{i}` is `convs.{i}` (its `Conv_0` / `BatchNorm_0` are `conv` /
`bn`). Children are registered in the natural order of the flax names
(`blocks` before `convs` in the backbone, `convs` before `blocks` in a
stage), which the JAX package's structural pairer walks.

`mish` is `F.mish`, x * tanh(softplus(x)). Torch's softplus returns x
above 20 where flax's `logaddexp(x, 0)` adds log1p(exp(-x)) < 2.1e-9,
which f32 cannot hold at x > 20; the two differ by rounding only.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import SameConv2d, batch_norm

__all__ = ["DarkConv", "ResBlock", "CSPStage", "CSPDarknet53",
           "cspdarknet53", "darknet53"]


class DarkConv(nn.Module):
    """Conv (SAME, no bias) -> BatchNorm (eps 1e-5) -> mish."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = SameConv2d(in_channels, filters, kernel, stride=stride,
                               bias=False)
        self.bn = batch_norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.mish(self.bn(self.conv(x)))


class ResBlock(nn.Module):
    def __init__(self, filters: int, hidden: int):
        super().__init__()
        self.convs = nn.ModuleList([DarkConv(filters, hidden, 1),
                                    DarkConv(hidden, filters, 3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.convs[1](self.convs[0](x))


class CSPStage(nn.Module):
    """`convs`: the stride-2 downsample, the residual branch's and the
    shortcut's 1x1 splits, the residual branch's closing 1x1 and the 1x1
    fuse, in flax's call order; `blocks`: the ResBlocks. The `first`
    stage keeps full width in both branches (YOLOv4)."""

    def __init__(self, in_channels: int, filters: int, num_blocks: int,
                 first: bool = False):
        super().__init__()
        split = filters if first else filters // 2
        hidden = filters // 2 if first else split
        self.convs = nn.ModuleList([
            DarkConv(in_channels, filters, 3, stride=2),
            DarkConv(filters, split, 1),
            DarkConv(filters, split, 1),
            DarkConv(split, split, 1),
            DarkConv(2 * split, filters, 1)])
        self.blocks = nn.ModuleList(ResBlock(split, hidden)
                                    for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convs[0](x)
        main = self.convs[1](x)
        shortcut = self.convs[2](x)
        for blk in self.blocks:
            main = blk(main)
        main = self.convs[3](main)
        return self.convs[4](torch.cat([main, shortcut], dim=1))


class CSPDarknet53(nn.Module):
    stride = 32

    def __init__(self, stage_blocks: Sequence[int] = (1, 2, 8, 8, 4),
                 stage_filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 in_channels: int = 3):
        super().__init__()
        self.stage_filters = tuple(stage_filters)
        stem = 32
        widths = (stem,) + self.stage_filters[:-1]
        self.blocks = nn.ModuleList(
            CSPStage(c, f, b, first=(i == 0))
            for i, (c, f, b) in enumerate(zip(widths, self.stage_filters,
                                              stage_blocks)))
        self.convs = nn.ModuleList([DarkConv(in_channels, stem, 3)])
        self.out_channels: List[int] = list(self.stage_filters[1:])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.convs[0](x)
        features = []
        for i, stage in enumerate(self.blocks):
            x = stage(x)
            if i >= 1:                    # strides 4, 8, 16, 32
                features.append(x)
        return features


def cspdarknet53(**kwargs) -> CSPDarknet53:
    return CSPDarknet53(**kwargs)


darknet53 = cspdarknet53  # the JAX package's alias: the CSP variant
