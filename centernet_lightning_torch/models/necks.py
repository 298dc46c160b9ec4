"""Necks (port of models/necks.py: FPN and build_neck).

A neck takes the backbone pyramid [C2, C3, C4, C5] (NCHW) and returns one
map, `stride` times finer than the coarsest input.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .layers import ConvNormAct, Upsample, get_conv_block

__all__ = ["FPN", "NECKS", "build_neck"]


class FPN(nn.Module):
    """Top-down feature pyramid; emits the finest level.

    `blocks` holds every block in the order the flax FPN calls them: the
    1x1 laterals on C2..C4 (no activation) and the 1x1 top on C5, all
    ConvNormAct, then per merge step from s16 down to s4 an optional 3x3
    narrowing block (`upsample_channels`) and the 3x3 merge block, both of
    `conv_type`. With `conv_type: normal` `blocks.{i}` is flax
    `ConvNormAct_{i}`; with a DCN type the 3x3 blocks are flax
    `DeformableConvBlock_{j}`, counted on their own, at
    `blocks.{len(in_channels) + j}` (utils/convert.py). The JAX package's structural weight pairer relies
    on this registration order.
    """

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 fuse_fn: str = "sum", weighted: bool = False,
                 upsample_type: str = "nearest", conv_type: str = "normal",
                 upsample_channels: Optional[Sequence[int]] = None):
        super().__init__()
        if weighted:
            raise NotImplementedError(
                "FPN(weighted=True) needs the Fuse node, ported with the "
                "remaining necks and blocks (ROADMAP Queue 1 item 8)")
        if fuse_fn not in ("sum", "concat"):
            raise ValueError(f"unknown fuse_fn {fuse_fn!r}")
        block = get_conv_block(conv_type)
        self.in_channels = tuple(in_channels)
        self.out_channels = out_channels
        self.fuse_fn = fuse_fn
        self.upsample_channels = (tuple(upsample_channels)
                                  if upsample_channels is not None else None)
        self.upsample = Upsample(upsample_type)

        levels = len(self.in_channels)
        blocks: List[nn.Module] = []
        lateral_widths = []
        for i, c in enumerate(self.in_channels[:-1]):
            w = self._step_width(levels - 2 - i)
            lateral_widths.append(w)
            blocks.append(ConvNormAct(c, w, 1, act=None))
        top_w = (self.upsample_channels[0]
                 if self.upsample_channels is not None else out_channels)
        blocks.append(ConvNormAct(self.in_channels[-1], top_w, 1, act=None))

        # per step: (index of the narrowing block or None, merge index)
        self._plan = []
        x_w = top_w
        for step, lat_w in enumerate(reversed(lateral_widths)):
            w = self._step_width(step)
            narrow = None
            if self.upsample_channels is not None and x_w != w:
                narrow = len(blocks)
                blocks.append(block(x_w, w, 3))
                x_w = w
            merge_in = lat_w + w if fuse_fn == "concat" else w
            self._plan.append((narrow, len(blocks)))
            blocks.append(block(merge_in, w, 3))
            x_w = w
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = x_w  # the emitted map's width

    @property
    def stride(self) -> int:
        return 2 ** (len(self.in_channels) - 1)

    def _step_width(self, step: int) -> int:
        if self.upsample_channels is not None:
            return self.upsample_channels[min(step,
                                              len(self.upsample_channels) - 1)]
        return self.out_channels

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        n_lat = len(features) - 1
        laterals = [self.blocks[i](f) for i, f in enumerate(features[:-1])]
        x = self.blocks[n_lat](features[-1])
        for (narrow, merge), lateral in zip(self._plan, reversed(laterals)):
            if narrow is not None:
                x = self.blocks[narrow](x)
            up = self.upsample(x)
            if self.fuse_fn == "concat":
                x = torch.cat([lateral, up], dim=1)
            else:
                x = lateral + up
            x = self.blocks[merge](x)
        return x


NECKS = {"FPN": FPN, "fpn": FPN}

_LATER = ("SimpleNeck", "simple", "BiFPN", "bifpn", "IDA", "ida")


def build_neck(name: str, in_channels: Sequence[int], **kwargs):
    if name in _LATER:
        raise NotImplementedError(
            f"neck {name!r} is ported with the remaining necks and blocks "
            f"(ROADMAP Queue 1 item 8)")
    if name not in NECKS:
        raise KeyError(f"unknown neck '{name}'; available: {sorted(NECKS)}")
    if kwargs.get("upsample_channels"):
        # progressive-width FPN: out_channels is the emitted map's width
        kwargs = dict(kwargs)
        kwargs.setdefault("out_channels", tuple(kwargs["upsample_channels"])[-1])
    return NECKS[name](in_channels=tuple(in_channels), **kwargs)
