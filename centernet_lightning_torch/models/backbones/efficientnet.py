"""EfficientNet-B0..B3 (port of models/backbones/efficientnet.py):
torchvision's MBConv trunk (expand 1x1 -> depthwise k x k -> squeeze-excite
-> project 1x1), SiLU, a sigmoid-gated SE whose reduction width is
max(1, in_c // 4) of the BLOCK INPUT, and stochastic-depth residuals;
compound scaling by `width_mult` (`_make_divisible`) and `depth_mult`
(ceil). `forward` takes NCHW and returns the maps at strides 4/8/16/32,
the first three taken just before the stride-2 blocks that leave them;
`out_channels` lists their widths.

Names: flax `ConvBNSiLU_{i}` is `convs.{i}` (the stem here; inside a block
expand, depthwise and project in call order), `MBConv_{i}` is `blocks.{i}`
and `SqueezeExciteSiLU_0` is `se` (`Conv_0` / `Conv_1`, with biases, are
`reduce` / `expand`). BatchNorm keeps flax's eps 1e-3 here.

Stochastic depth (`stochastic_depth_prob` > 0, linear in the block's
depth) drops whole rows of a residual branch in training, with a keep
mask drawn from `generator` (`torch.rand(...) < keep`, divided by keep).
The JAX package draws it from a "dropout" rng and raises without one; a
training forward without a generator raises likewise. In eval, and at
rate 0, the blocks are deterministic.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import SameConv2d, batch_norm
from .mobilenet import _make_divisible

__all__ = ["ConvBNSiLU", "SqueezeExciteSiLU", "MBConv", "EfficientNet",
           "efficientnet_b0", "efficientnet_b1", "efficientnet_b2",
           "efficientnet_b3"]

BN_EPS = 1e-3
# expand, kernel, stride, out_c, repeats: the B0 stage table
STAGES = ((1, 3, 1, 16, 1), (6, 3, 2, 24, 2), (6, 5, 2, 40, 2),
          (6, 3, 2, 80, 3), (6, 5, 1, 112, 3), (6, 5, 2, 192, 4),
          (6, 3, 1, 320, 1))


class ConvBNSiLU(nn.Module):
    """Conv (SAME, no bias) -> BatchNorm (eps 1e-3) [-> SiLU]."""

    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = SameConv2d(in_channels, filters, kernel, stride=stride,
                               groups=groups, bias=False)
        self.bn = batch_norm(filters, eps=BN_EPS)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class SqueezeExciteSiLU(nn.Module):
    """SiLU on the squeeze, a true sigmoid gate."""

    def __init__(self, channels: int, reduce_channels: int):
        super().__init__()
        self.reduce = nn.Conv2d(channels, reduce_channels, 1)
        self.expand = nn.Conv2d(reduce_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.silu(self.reduce(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.expand(s))


class MBConv(nn.Module):
    def __init__(self, in_channels: int, filters: int, kernel: int = 3,
                 stride: int = 1, expand: int = 6, sd_prob: float = 0.0):
        super().__init__()
        hidden = in_channels * expand
        convs = [ConvBNSiLU(in_channels, hidden, 1)] if expand != 1 else []
        convs += [ConvBNSiLU(hidden, hidden, kernel, stride=stride, groups=hidden),
                  ConvBNSiLU(hidden, filters, 1, act=False)]
        self.convs = nn.ModuleList(convs)
        self.se = SqueezeExciteSiLU(hidden, max(1, in_channels // 4))
        self.sd_prob = sd_prob
        self.residual = stride == 1 and in_channels == filters

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = x
        for conv in self.convs[:-1]:
            y = conv(y)
        y = self.convs[-1](self.se(y))
        if not self.residual:
            return y
        if self.training and self.sd_prob > 0.0:
            if generator is None:
                raise ValueError(
                    "stochastic depth in training needs a torch.Generator "
                    "(EfficientNet.generator), as the JAX package needs a "
                    "'dropout' rng")
            keep = 1.0 - self.sd_prob
            mask = torch.rand((y.shape[0], 1, 1, 1), generator=generator,
                              device=y.device) < keep
            y = y * mask.to(y.dtype) / keep
        return y + x


class EfficientNet(nn.Module):
    """Compound-scaled EfficientNet trunk (no classifier head).
    `generator` feeds stochastic depth in training (see the module)."""

    stride = 32

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 stochastic_depth_prob: float = 0.0, in_channels: int = 3):
        super().__init__()
        self.width_mult = width_mult
        self.depth_mult = depth_mult
        self.generator: Optional[torch.Generator] = None
        self.convs = nn.ModuleList([ConvBNSiLU(in_channels, self._c(32), 3,
                                               stride=2)])
        total = sum(self._n(n) for *_, n in STAGES)
        blocks, self.taps = [], []
        in_c, cur_stride = self._c(32), 2
        for expand, kernel, s, out_c, n in STAGES:
            for i in range(self._n(n)):
                stride = s if i == 0 else 1
                if stride == 2 and cur_stride in (4, 8, 16):
                    self.taps.append(len(blocks))   # the map entering block
                # torchvision scales the drop rate linearly with depth
                sd = stochastic_depth_prob * len(blocks) / max(1, total)
                blocks.append(MBConv(in_c, self._c(out_c), kernel, stride,
                                     expand, sd))
                in_c = self._c(out_c)
                if stride == 2:
                    cur_stride *= 2
        self.blocks = nn.ModuleList(blocks)
        # taps after stages 2 (s4), 3 (s8), 5 (s16), 7 (s32)
        self.out_channels: List[int] = [self._c(24), self._c(40), self._c(112),
                                        self._c(320)]

    def _c(self, v: int) -> int:
        return _make_divisible(v * self.width_mult)

    def _n(self, n: int) -> int:
        return int(math.ceil(n * self.depth_mult))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.convs[0](x)
        features = []
        for i, block in enumerate(self.blocks):
            if i in self.taps:
                features.append(x)
            x = block(x, self.generator)
        features.append(x)
        return features[-4:]


def efficientnet_b0(**kwargs) -> EfficientNet:
    return EfficientNet(**kwargs)


def efficientnet_b1(**kwargs) -> EfficientNet:
    return EfficientNet(**{"width_mult": 1.0, "depth_mult": 1.1, **kwargs})


def efficientnet_b2(**kwargs) -> EfficientNet:
    return EfficientNet(**{"width_mult": 1.1, "depth_mult": 1.2, **kwargs})


def efficientnet_b3(**kwargs) -> EfficientNet:
    return EfficientNet(**{"width_mult": 1.2, "depth_mult": 1.4, **kwargs})
