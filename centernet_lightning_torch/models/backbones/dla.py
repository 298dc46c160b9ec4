"""DLA-34 (port of models/backbones/dla.py): a stride-1 7x7 base layer, two
plain conv levels, then four hierarchical-aggregation Trees whose Roots
concatenate their children and fuse them with a 1x1 conv; `level_root`
Trees also feed their pooled input into the Root. `forward` takes NCHW and
returns [level2 .. level5] (strides 4/8/16/32); `out_channels` is
`channels[2:]`.

Names are the flax scopes' own: `base_conv` / `base_bn`,
`level{0,1}_conv{i}` / `level{0,1}_bn{i}`, `level{2..5}` (Trees) with
`tree1`, `tree2`, `root` (`conv`, `bn`), `project_conv`, `project_bn`,
recursively; a basic block's flax `Conv_{i}` / `BatchNorm_{i}` are
`conv{i+1}` / `bn{i+1}`.

As in the JAX package, a Tree with `levels > 1` builds and runs
`project_conv` / `project_bn` on its pooled input and drops the result
(its subtrees project for themselves): the parameters exist, the
convolution is calibrated by int8 serving, and in training the
BatchNorm's statistics move.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import batch_norm

__all__ = ["DLABasicBlock", "Root", "Tree", "DLA", "dla34", "dla34_small"]


def _conv(in_c: int, out_c: int, k: int, stride: int = 1) -> nn.Conv2d:
    """No bias, explicit padding k // 2 (flax's [(p, p), (p, p)])."""
    return nn.Conv2d(in_c, out_c, k, stride=stride, padding=k // 2, bias=False)


class DLABasicBlock(nn.Module):
    """3x3-3x3 residual block; the enclosing Tree supplies the residual."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_channels, filters, 3, stride)
        self.bn1 = batch_norm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = batch_norm(filters)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class Root(nn.Module):
    """Concatenated children -> 1x1 conv -> BN (-> + children[0]) -> ReLU."""

    def __init__(self, in_channels: int, filters: int, residual: bool = False):
        super().__init__()
        self.conv = _conv(in_channels, filters, 1)
        self.bn = batch_norm(filters)
        self.residual = residual

    def forward(self, children: List[torch.Tensor]) -> torch.Tensor:
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """levels == 1: two blocks and a Root over [block2, block1, *children];
    levels > 1: two subtrees, the first's output among the second's root
    children. `children_channels` are the widths of the children the
    caller passes in."""

    def __init__(self, in_channels: int, levels: int, filters: int,
                 stride: int = 1, level_root: bool = False,
                 root_residual: bool = False,
                 children_channels: Sequence[int] = ()):
        super().__init__()
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        children_channels = list(children_channels)
        if level_root:
            children_channels.append(in_channels)
        if levels == 1:
            self.tree1 = DLABasicBlock(in_channels, filters, stride)
            self.tree2 = DLABasicBlock(filters, filters, 1)
            self.root = Root(2 * filters + sum(children_channels), filters,
                             root_residual)
        else:
            self.tree1 = Tree(in_channels, levels - 1, filters, stride,
                              root_residual=root_residual)
            self.tree2 = Tree(filters, levels - 1, filters, 1,
                              root_residual=root_residual,
                              children_channels=children_channels + [filters])
        if in_channels != filters:
            self.project_conv = _conv(in_channels, filters, 1)
            self.project_bn = batch_norm(filters)
        else:
            self.project_conv = self.project_bn = None

    def forward(self, x: torch.Tensor,
                children: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        children = list(children or [])
        # reduce_window VALID, k = s: F.max_pool2d's floor
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        if self.project_conv is not None:
            residual = self.project_bn(self.project_conv(bottom))
        else:
            residual = bottom
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1, x1)
            return self.root([x2, x1] + children)
        # `residual` is dropped here, as in the JAX Tree
        x1 = self.tree1(x)
        return self.tree2(x1, children + [x1])


class DLA(nn.Module):
    stride = 32

    def __init__(self, levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 root_residual: bool = False, in_channels: int = 3):
        super().__init__()
        self.levels = tuple(levels)
        self.base_conv = _conv(in_channels, channels[0], 7)
        self.base_bn = batch_norm(channels[0])
        in_c = channels[0]
        for name, filters, convs, stride in (("level0", channels[0], levels[0], 1),
                                             ("level1", channels[1], levels[1], 2)):
            for i in range(convs):
                self.add_module(f"{name}_conv{i}", _conv(
                    in_c, filters, 3, stride if i == 0 else 1))
                self.add_module(f"{name}_bn{i}", batch_norm(filters))
                in_c = filters
        for i in range(2, 6):
            self.add_module(f"level{i}", Tree(
                in_c, levels[i], channels[i], stride=2, level_root=i > 2,
                root_residual=root_residual))
            in_c = channels[i]
        self.out_channels: List[int] = list(channels[2:])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.base_bn(self.base_conv(x)))
        for name in ("level0", "level1"):
            for i in range(self.levels[int(name[-1])]):
                x = getattr(self, f"{name}_conv{i}")(x)
                x = F.relu(getattr(self, f"{name}_bn{i}")(x))
        features = []
        for i in range(2, 6):
            x = getattr(self, f"level{i}")(x)
            features.append(x)
        return features


def dla34(**kwargs) -> DLA:
    return DLA(**{"levels": (1, 1, 1, 2, 2, 1),
                  "channels": (16, 32, 64, 128, 256, 512), **kwargs})


def dla34_small(**kwargs) -> DLA:
    """The reduced-width variant (in-house, dla34's topology)."""
    return DLA(**{"levels": (1, 1, 1, 2, 2, 1),
                  "channels": (16, 32, 64, 64, 128, 256), **kwargs})
