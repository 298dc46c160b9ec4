"""Output heads (port of models/heads.py: GenericHead, ReIDClassifier).

`blocks.{i}` is flax `ConvNormAct_{i}` (or `DeformableConvBlock_{i}` for a
DCN `block`) and `out_conv` is flax `out_conv`. FairMOT's ReID head is a
GenericHead of emb_dim channels (models/meta.py builds it);
ReIDClassifier's `fc1`, `bn`, `fc2` are flax `Dense_0`, `BatchNorm_0`,
`Dense_1`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import BN_EPS, BN_MOMENTUM, BatchNorm1d, get_conv_block

__all__ = ["GenericHead", "ReIDClassifier"]


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


class ReIDClassifier(nn.Module):
    """The train-only identity classifier over (M, emb_dim) gathered
    embeddings: Linear (no bias) -> BatchNorm over the M rows (flax's
    statistics) -> ReLU -> Linear to `max_track_ids` logits."""

    def __init__(self, emb_dim: int, max_track_ids: int):
        super().__init__()
        self.fc1 = nn.Linear(emb_dim, emb_dim, bias=False)
        self.bn = BatchNorm1d(emb_dim, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.fc2 = nn.Linear(emb_dim, max_track_ids)

    def forward(self, embeddings: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.bn(self.fc1(embeddings))))
