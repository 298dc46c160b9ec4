"""MobileNetV2 / V3-Large / V3-Small (port of
models/backbones/mobilenet.py), torchvision's stage layouts; `forward`
takes NCHW and returns the maps at strides 4/8/16/32.

Names: flax `ConvBN_{i}` is `convs.{i}` (the stem, and inside a block the
expand, depthwise and project convs in call order), `InvertedResidual_{i}`
is `blocks.{i}` and `SqueezeExcite_0` is `se` (its `Conv_0` / `Conv_1`,
with bias, are `reduce` / `expand`). `convs` is registered before
`blocks` and `se`, the natural order of the flax names.

BatchNorm here keeps flax's eps 1e-3 (the rest of the port: 1e-5).
`relu6` and `hard_sigmoid` are spelled as the JAX package spells them,
`minimum(relu(x), 6)` and `clip(x / 6 + 0.5, 0, 1)` through
`torch.maximum` / `torch.minimum`, which split the gradient at a tie as
jnp.minimum / jnp.clip do (`F.relu6` / `F.hardsigmoid` / `clamp` pass all
of it, and `F.hardsigmoid` also rounds otherwise).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import SameConv2d, batch_norm

__all__ = ["ConvBN", "SqueezeExcite", "InvertedResidual", "MobileNetV2",
           "MobileNetV3Large", "MobileNetV3Small", "mobilenet_v2",
           "mobilenet_v3_large", "mobilenet_v3_small"]

BN_EPS = 1e-3


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel rounding (SE widths)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(F.relu(x), x.new_tensor(6.0))


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    y = x / 6.0 + 0.5
    return torch.minimum(torch.maximum(y, y.new_tensor(0.0)), y.new_tensor(1.0))


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


_ACTS = {"relu6": relu6, "relu": F.relu, "hswish": hard_swish, "none": None}


class ConvBN(nn.Module):
    """Conv (SAME, no bias) -> BatchNorm (eps 1e-3) -> relu6 / relu /
    hswish / none."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: str = "relu6"):
        super().__init__()
        self.conv = SameConv2d(in_channels, filters, kernel, stride=stride,
                               groups=groups, bias=False)
        self.bn = batch_norm(filters, eps=BN_EPS)
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduce_channels: int):
        super().__init__()
        self.reduce = nn.Conv2d(channels, reduce_channels, 1)
        self.expand = nn.Conv2d(reduce_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.relu(self.reduce(s)))
        return x * hard_sigmoid(s)


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 expand: float = 6.0, kernel: int = 3, se: bool = False,
                 act: str = "relu6"):
        super().__init__()
        hidden = int(round(in_channels * expand))
        convs = []
        if hidden != in_channels:
            convs.append(ConvBN(in_channels, hidden, 1, act=act))
        convs.append(ConvBN(hidden, hidden, kernel, stride=stride,
                            groups=hidden, act=act))
        convs.append(ConvBN(hidden, filters, 1, act="none"))
        self.convs = nn.ModuleList(convs)
        self.se: Optional[SqueezeExcite] = (
            SqueezeExcite(hidden, _make_divisible(max(1, hidden // 4)))
            if se else None)
        self.residual = stride == 1 and in_channels == filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for conv in self.convs[:-1]:
            y = conv(y)
        if self.se is not None:
            y = self.se(y)
        y = self.convs[-1](y)
        return y + x if self.residual else y


class _MobileNet(nn.Module):
    """A stem ConvBN and a stack of InvertedResiduals; the map entering
    each stride-2 block at strides 4, 8 and 16 is tapped, and the last
    one closes the pyramid."""

    stride = 32

    def __init__(self, stem: ConvBN, blocks: List[InvertedResidual],
                 strides: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList([stem])
        self.blocks = nn.ModuleList(blocks)
        self._taps, cur = set(), 2
        for i, s in enumerate(strides):
            if s == 2:
                if cur in (4, 8, 16):
                    self._taps.add(i)
                cur *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.convs[0](x)
        features = []
        for i, blk in enumerate(self.blocks):
            if i in self._taps:
                features.append(x)
            x = blk(x)
        features.append(x)
        return features[-4:]


class MobileNetV2(_MobileNet):
    """torchvision MobileNetV2 layout; taps 24/32/96/320 x width_mult."""

    # t (expand), c (out), n (repeats), s (first stride)
    _cfg: Sequence[Tuple[float, int, int, int]] = (
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, width_mult: float = 1.0, in_channels: int = 3):
        def c(v):
            return int(round(v * width_mult))

        in_c = c(32)
        stem = ConvBN(in_channels, in_c, 3, stride=2)
        blocks, strides = [], []
        for t, ch, n, s in self._cfg:
            for i in range(n):
                stride = s if i == 0 else 1
                blocks.append(InvertedResidual(in_c, c(ch), stride=stride,
                                               expand=t))
                strides.append(stride)
                in_c = c(ch)
        super().__init__(stem, blocks, strides)
        self.out_channels: List[int] = [c(24), c(32), c(96), c(320)]


class MobileNetV3Large(_MobileNet):
    """torchvision MobileNetV3-Large layout; taps 24/40/112/160."""

    # kernel, expand_c, out_c, se, act, stride
    _cfg = (
        (3, 16, 16, False, "relu", 1),
        (3, 64, 24, False, "relu", 2),
        (3, 72, 24, False, "relu", 1),
        (5, 72, 40, True, "relu", 2),
        (5, 120, 40, True, "relu", 1),
        (5, 120, 40, True, "relu", 1),
        (3, 240, 80, False, "hswish", 2),
        (3, 200, 80, False, "hswish", 1),
        (3, 184, 80, False, "hswish", 1),
        (3, 184, 80, False, "hswish", 1),
        (3, 480, 112, True, "hswish", 1),
        (3, 672, 112, True, "hswish", 1),
        (5, 672, 160, True, "hswish", 2),
        (5, 960, 160, True, "hswish", 1),
        (5, 960, 160, True, "hswish", 1),
    )
    _out_channels = (24, 40, 112, 160)

    def __init__(self, in_channels: int = 3):
        in_c = 16
        stem = ConvBN(in_channels, in_c, 3, stride=2, act="hswish")
        blocks, strides = [], []
        for kernel, exp_c, out_c, se, act, s in self._cfg:
            blocks.append(InvertedResidual(in_c, out_c, stride=s,
                                           expand=exp_c / in_c, kernel=kernel,
                                           se=se, act=act))
            strides.append(s)
            in_c = out_c
        super().__init__(stem, blocks, strides)
        self.out_channels: List[int] = list(self._out_channels)


class MobileNetV3Small(MobileNetV3Large):
    """torchvision MobileNetV3-Small layout; taps 16/24/48/96 (its first
    block is stride 2 with SE, so the stride-4 tap is its output)."""

    _cfg = (
        (3, 16, 16, True, "relu", 2),
        (3, 72, 24, False, "relu", 2),
        (3, 88, 24, False, "relu", 1),
        (5, 96, 40, True, "hswish", 2),
        (5, 240, 40, True, "hswish", 1),
        (5, 240, 40, True, "hswish", 1),
        (5, 120, 48, True, "hswish", 1),
        (5, 144, 48, True, "hswish", 1),
        (5, 288, 96, True, "hswish", 2),
        (5, 576, 96, True, "hswish", 1),
        (5, 576, 96, True, "hswish", 1),
    )
    _out_channels = (16, 24, 48, 96)


def mobilenet_v2(**kwargs) -> MobileNetV2:
    return MobileNetV2(**kwargs)


def mobilenet_v3_large(**kwargs) -> MobileNetV3Large:
    return MobileNetV3Large(**kwargs)


def mobilenet_v3_small(**kwargs) -> MobileNetV3Small:
    return MobileNetV3Small(**kwargs)
