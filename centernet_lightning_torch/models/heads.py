"""Output heads (port of models/heads.py: GenericHead).

`blocks.{i}` is flax `ConvNormAct_{i}` (or `DeformableConvBlock_{i}` for a
DCN `block`) and `out_conv` is flax `out_conv`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import get_conv_block

__all__ = ["GenericHead"]


class GenericHead(nn.Module):
    """depth x block(width, 3), then a 1x1 `out_conv` whose bias is
    filled with `init_bias` (zeros when None)."""

    def __init__(self, in_channels: int, out_channels: int, width: int = 256,
                 depth: int = 3, block: str = "normal",
                 init_bias: Optional[float] = None):
        super().__init__()
        block_cls = get_conv_block(block)
        self.blocks = nn.ModuleList(
            block_cls(in_channels if i == 0 else width, width, 3)
            for i in range(depth))
        self.out_conv = nn.Conv2d(width if depth else in_channels,
                                  out_channels, 1)
        self.init_bias = init_bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.out_conv(x)
