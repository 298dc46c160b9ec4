"""VoVNet-19 / 39 / 57 (port of models/backbones/vovnet.py): a stride-4
stem of three ConvBN, then four stages of One-Shot-Aggregation blocks
(a chain of 3x3 ConvBN whose outputs are concatenated once with the
block's input and fused by a 1x1 ConvBN, then the eSE gate); stages after
the first open with a 3x3 / s2 max pool. `forward` takes NCHW and returns
the four stages' maps (strides 4/8/16/32); `out_channels` is
`concat_channels`.

Names: flax `ConvBN_{i}` is `convs.{i}` (the stem here; inside a block the
chain, then the 1x1), `OSABlock_{i}` is `blocks.{i}` (numbered over all
stages, as flax numbers them in call order), `ESE_0` is `ese` (its
`Conv_0`, with bias, `ese.conv`).

Padding is flax's `SAME` throughout: the strided stem convolutions pad
(0, 1) on even sizes (`SameConv2d`), and so does the stage pool, which is
a 3x3 / s2 `reduce_window` with SAME padding in the JAX package: -inf
padding through `F.pad`, then an unpadded pool (`F.max_pool2d(padding=1)`
and `csrc/max_pool.cu` pad (1, 1)).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import SameConv2d, batch_norm, same_pads
from .mobilenet import hard_sigmoid

__all__ = ["ConvBN", "ESE", "OSABlock", "VoVNet", "vovnet19", "vovnet39",
           "vovnet57"]


class ConvBN(nn.Module):
    """Conv (SAME, no bias) -> BatchNorm -> ReLU."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = SameConv2d(in_channels, filters, kernel, stride=stride,
                               bias=False)
        self.bn = batch_norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class ESE(nn.Module):
    """Effective squeeze-excite (VoVNetV2): x * clip(conv(mean(x)) / 6 +
    0.5, 0, 1), the 1x1 convolution with a bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.conv(x.mean(dim=(2, 3), keepdim=True))
        return x * hard_sigmoid(s)


class OSABlock(nn.Module):
    def __init__(self, in_channels: int, stage_channels: int,
                 concat_channels: int, num_convs: int = 5,
                 identity: bool = False):
        super().__init__()
        chain = [ConvBN(in_channels if i == 0 else stage_channels,
                        stage_channels, 3) for i in range(num_convs)]
        fuse = ConvBN(in_channels + num_convs * stage_channels,
                      concat_channels, 1)
        self.convs = nn.ModuleList(chain + [fuse])
        self.ese = ESE(concat_channels)
        self.identity = identity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = [x]
        y = x
        for conv in self.convs[:-1]:
            y = conv(y)
            inputs.append(y)
        y = self.ese(self.convs[-1](torch.cat(inputs, dim=1)))
        if self.identity and x.shape == y.shape:
            y = y + x
        return y


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 / s2 max pool with flax's SAME padding ((0, 1) on an even size,
    (1, 1) on an odd one), -inf in the pad."""
    top, bottom = same_pads(x.shape[2], 3, 2)
    left, right = same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


class VoVNet(nn.Module):
    stride = 32

    def __init__(self, stage_channels: Sequence[int] = (128, 160, 192, 224),
                 concat_channels: Sequence[int] = (256, 512, 768, 1024),
                 num_blocks: Sequence[int] = (1, 1, 2, 2), num_convs: int = 5,
                 in_channels: int = 3):
        super().__init__()
        self.convs = nn.ModuleList([ConvBN(in_channels, 64, 3, stride=2),
                                    ConvBN(64, 64, 3),
                                    ConvBN(64, 128, 3, stride=2)])
        blocks, self.stage_ends = [], []
        in_c = 128
        for sc, cc, nb in zip(stage_channels, concat_channels, num_blocks):
            for b in range(nb):
                blocks.append(OSABlock(in_c, sc, cc, num_convs, identity=b > 0))
                in_c = cc
            self.stage_ends.append(len(blocks))
        self.blocks = nn.ModuleList(blocks)
        self.out_channels: List[int] = list(concat_channels)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        for conv in self.convs:
            x = conv(x)
        features, start = [], 0
        for stage, end in enumerate(self.stage_ends):
            if stage > 0:
                x = max_pool_same(x)
            for block in self.blocks[start:end]:
                x = block(x)
            features.append(x)
            start = end
        return features


def vovnet19(**kwargs) -> VoVNet:
    return VoVNet(**{"num_blocks": (1, 1, 1, 1), "num_convs": 3, **kwargs})


def vovnet39(**kwargs) -> VoVNet:
    return VoVNet(**{"num_blocks": (1, 1, 2, 2), **kwargs})


def vovnet57(**kwargs) -> VoVNet:
    return VoVNet(**{"num_blocks": (1, 1, 4, 3), **kwargs})
