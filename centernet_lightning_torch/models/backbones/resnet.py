"""ResNet backbones (port of models/backbones/resnet.py).

Key names are torchvision's (`conv1`, `bn1`, `layer{s}.{b}.conv{i}` /
`bn{i}` / `downsample.{0,1}`), so `utils/torch_convert.py:
convert_resnet_state_dict` of the JAX package maps a state dict exactly.

`forward` takes NCHW and returns the pyramid [C2(s4), C3(s8), C4(s16),
C5(s32)]; `out_channels` lists their widths and `stride` is 32.

`remat` is the JAX package's option of that name (see `ResNet`).
`stem_space_to_depth` is accepted and runs the plain stem: the JAX
package's space-to-depth stem is the same function, regrouped into a 4x4
stride-1 convolution for the TPU's layout, and on the card the regrouped
form is the slower one.

`frozen_stages=k` freezes the stem and layer1..layerk as the JAX package
does: their BatchNorms run on running statistics in train mode (`train()`
keeps them in eval), and the map leaving each frozen stage is detached,
so no gradient reaches them. The optimizer gives them zero updates
(train/optim.py).
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence, Type, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..layers import batch_norm, recomputing

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "StemConv",
           "resnet18", "resnet34", "resnet50", "resnet101"]


def _conv(in_c: int, out_c: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_c, out_c, k, stride=stride, padding=k // 2,
                     bias=False)


class StemConv(nn.Conv2d):
    """The 7x7 / stride-2 stem convolution (padding 3, no bias). A class of
    its own as in the JAX package, whose `StemConv` is no flax `nn.Conv`:
    int8 serving (quantize.py) leaves it in float there, and so here."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 7, stride=2, padding=3,
                         bias=False)


def _downsample(in_c: int, out_c: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(in_c, out_c, 1, stride), batch_norm(out_c))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_channels, filters, 3, stride)
        self.bn1 = batch_norm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = batch_norm(filters)
        # the flax block projects whenever the residual's shape differs
        self.downsample = (_downsample(in_channels, filters, stride)
                           if stride != 1 or in_channels != filters else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        out_c = filters * self.expansion
        self.conv1 = _conv(in_channels, filters, 1)
        self.bn1 = batch_norm(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = batch_norm(filters)
        self.conv3 = _conv(filters, out_c, 1)
        self.bn3 = batch_norm(out_c)
        self.downsample = (_downsample(in_channels, out_c, stride)
                           if stride != 1 or in_channels != out_c else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


def _remat(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`block(x)` under `torch.utils.checkpoint`. The block's parameters
    as they are now go in as inputs and the recompute runs on them: a
    bf16 train step calls the model through `functional_call` with bf16
    copies, which are gone from the module by the time the backward
    recomputes."""
    names, tensors = zip(*block.named_parameters())

    def run(x, *tensors):
        return functional_call(block, dict(zip(names, tensors)), (x,))

    return checkpoint(run, x, *tensors, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recomputing()))


class ResNet(nn.Module):
    """7x7/s2 stem + BN + ReLU + 3x3/s2 max pool, then four stages.

    `remat=True` runs each block under `torch.utils.checkpoint` in training
    (the JAX package's `nn.remat` a block): its activations are recomputed
    in the backward instead of kept, and the recompute leaves the running
    statistics as the forward set them."""

    stride = 32

    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: Type[Union[BasicBlock, Bottleneck]],
                 width: int = 64, in_channels: int = 3,
                 stem_space_to_depth: bool = False, remat: bool = False,
                 frozen_stages: int = 0):
        super().__init__()
        del stem_space_to_depth          # the plain stem (module docstring)
        self.stage_sizes = tuple(stage_sizes)
        self.frozen_stages = int(frozen_stages)
        self.remat = remat
        self.width = width
        self.conv1 = StemConv(in_channels, width)
        self.bn1 = batch_norm(width)
        in_c = width
        for stage, num_blocks in enumerate(self.stage_sizes):
            filters = width * 2 ** stage
            blocks = []
            for b in range(num_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(block_cls(in_c, filters, stride))
                in_c = filters * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_channels: List[int] = [
            width * 2 ** i * block_cls.expansion for i in range(4)]

    def stages(self) -> List[List[nn.Module]]:
        """The modules of the stem, then of each stage: what
        `frozen_stages=k` freezes is `stages()[:k + 1]`."""
        return [[self.conv1, self.bn1]] + [
            [getattr(self, f"layer{s + 1}")] for s in range(len(self.stage_sizes))]

    def train(self, mode: bool = True) -> "ResNet":
        super().train(mode)
        if mode and self.frozen_stages > 0:
            for stage in self.stages()[:self.frozen_stages + 1]:
                for mod in stage:
                    mod.eval()
        return self

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.frozen_stages >= 1:
            x = x.detach()
        features = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for stage in range(len(self.stage_sizes)):
            for block in getattr(self, f"layer{stage + 1}"):
                if remat:
                    x = _remat(block, x)
                else:
                    x = block(x)
            if stage + 1 <= self.frozen_stages:
                x = x.detach()
            features.append(x)
        return features


def resnet18(**kwargs) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, **kwargs)


def resnet34(**kwargs) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, **kwargs)


def resnet50(**kwargs) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, **kwargs)


def resnet101(**kwargs) -> ResNet:
    return ResNet((3, 4, 23, 3), Bottleneck, **kwargs)
