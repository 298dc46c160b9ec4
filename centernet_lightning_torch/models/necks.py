"""Necks (port of models/necks.py: SimpleNeck, FPN, BiFPN, IDA and
build_neck), and CenterNet's own DLA-34 neck `DLAUp`, which the JAX
package does not have.

A neck takes the backbone pyramid [C2, C3, C4, C5] (NCHW) and returns one
map, `stride` times finer than the coarsest input; FPN and BiFPN can
return the whole pyramid, finest first (`return_pyramid`).

Each neck registers its children class by class in flax's counter order
(`blocks`, then `upsamples` or `fuses`), which is the natural sort of the
flax scope names that the JAX package's structural pairer
(utils/torch_convert.py) walks. Within `blocks` the plain ConvNormActs
come first, then the DCN or separable blocks, so flax
`DeformableConvBlock_{j}` / `SeparableConvNormAct_{j}` is `blocks.{P + j}`
after the P plain ones (utils/convert.py); a neck whose calls interleave
the two keeps a plan of indices.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..utils.spans import span
from .layers import (ConvNormAct, DepthwiseUpsample, Fuse, Upsample,
                     get_conv_block)

__all__ = ["SimpleNeck", "FPN", "BiFPN", "IDA", "IDAUp", "DLAUp", "NECKS",
           "build_neck"]


def _ordered_blocks(entries):
    """(module, is_plain) in call order -> (ModuleList with the plain
    blocks first, each entry's index in it)."""
    plain = [m for m, is_plain in entries if is_plain]
    other = [m for m, is_plain in entries if not is_plain]
    index, seen = [], {True: 0, False: len(plain)}
    for _, is_plain in entries:
        index.append(seen[is_plain])
        seen[is_plain] += 1
    return nn.ModuleList(plain + other), index


class SimpleNeck(nn.Module):
    """Upsample stack on the coarsest map (CenterNet's original neck).

    Per step: a 3x3 `conv_type` block to `ch`, an x2 `Upsample`
    (`upsample_type`; `deconv_kernel` / `deconv_init_bilinear` shape the
    conv_transpose form), then with `skip_kernel` > 0 a lateral skip
    ConvNormAct(skip_kernel, no activation) from the pyramid level now at
    the map's resolution, added to it. `upsamples.{j}` is flax
    `Upsample_{j}`; the step blocks and skips are in `blocks` (plain
    first, see the module docstring).
    """

    def __init__(self, in_channels: Sequence[int],
                 upsample_channels: Sequence[int] = (256, 128, 64),
                 upsample_type: str = "nearest", conv_type: str = "normal",
                 deconv_kernel: int = 4, deconv_init_bilinear: bool = True,
                 skip_kernel: int = 0):
        super().__init__()
        block = get_conv_block(conv_type)
        self.in_channels = tuple(in_channels)
        self.upsample_channels = tuple(upsample_channels)
        entries, ups, skips = [], [], []
        x_w = self.in_channels[-1]
        for step, ch in enumerate(self.upsample_channels):
            blk = block(x_w, ch, 3)
            entries.append((blk, type(blk) is ConvNormAct))
            ups.append(Upsample(upsample_type, ch, kernel_size=deconv_kernel,
                                init_bilinear=deconv_init_bilinear))
            skip_idx = len(self.in_channels) - 2 - step
            if skip_kernel and skip_idx >= 0:
                skips.append(skip_idx)
                entries.append((ConvNormAct(self.in_channels[skip_idx], ch,
                                            skip_kernel, act=None), True))
            else:
                skips.append(None)
            x_w = ch
        self.blocks, index = _ordered_blocks(entries)
        self.upsamples = nn.ModuleList(ups)
        # per step: (block index, skip block index or None, pyramid level)
        it = iter(index)
        self._plan = [(next(it), None if s is None else next(it), s)
                      for s in skips]

    @property
    def out_channels(self) -> int:
        return self.upsample_channels[-1]

    @property
    def stride(self) -> int:
        return 2 ** len(self.upsample_channels)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        x = features[-1]
        for (blk, skip, level), up in zip(self._plan, self.upsamples):
            x = up(self.blocks[blk](x))
            if skip is not None:
                x = x + self.blocks[skip](features[level])
        return x


class FPN(nn.Module):
    """Top-down feature pyramid; emits the finest level.

    `blocks` holds the 1x1 laterals on C2..C4 (no activation) and the 1x1
    top on C5, all ConvNormAct, then per merge step from s16 down to s4 an
    optional 3x3 narrowing block (`upsample_channels`) and the 3x3 merge
    block, both of `conv_type`. With `conv_type: normal` `blocks.{i}` is
    flax `ConvNormAct_{i}`; with a DCN or separable type the 3x3 blocks
    are counted on their own, at `blocks.{len(in_channels) + j}`.
    `upsamples.{j}` is step j's `Upsample` (weights only for
    conv_transpose). `weighted` merges each level with a `Fuse([lateral,
    x])` (`fuses.{j}`, flax `Fuse_{j}`) instead.
    """

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 fuse_fn: str = "sum", weighted: bool = False,
                 upsample_type: str = "nearest", conv_type: str = "normal",
                 upsample_channels: Optional[Sequence[int]] = None):
        super().__init__()
        if fuse_fn not in ("sum", "concat"):
            raise ValueError(f"unknown fuse_fn {fuse_fn!r}")
        block = get_conv_block(conv_type)
        self.in_channels = tuple(in_channels)
        self.out_channels = out_channels
        self.fuse_fn = fuse_fn
        self.weighted = weighted
        self.upsample_channels = (tuple(upsample_channels)
                                  if upsample_channels is not None else None)

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
        ups, fuses = [], []
        x_w = top_w
        for step, lat_w in enumerate(reversed(lateral_widths)):
            w = self._step_width(step)
            if weighted:
                fuses.append(Fuse((lat_w, x_w), w, weighted=True,
                                  upsample=upsample_type, conv_type=conv_type))
                x_w = w
                continue
            narrow = None
            if self.upsample_channels is not None and x_w != w:
                narrow = len(blocks)
                blocks.append(block(x_w, w, 3))
                x_w = w
            ups.append(Upsample(upsample_type, w))
            merge_in = lat_w + w if fuse_fn == "concat" else w
            self._plan.append((narrow, len(blocks)))
            blocks.append(block(merge_in, w, 3))
            x_w = w
        self.blocks = nn.ModuleList(blocks)
        self.upsamples = nn.ModuleList(ups)
        self.fuses = nn.ModuleList(fuses)
        self.out_channels = x_w  # the emitted map's width

    @property
    def stride(self) -> int:
        return 2 ** (len(self.in_channels) - 1)

    def _step_width(self, step: int) -> int:
        if self.upsample_channels is not None:
            return self.upsample_channels[min(step,
                                              len(self.upsample_channels) - 1)]
        return self.out_channels

    def forward(self, features: List[torch.Tensor],
                return_pyramid: bool = False):
        n_lat = len(features) - 1
        laterals = [self.blocks[i](f) for i, f in enumerate(features[:-1])]
        x = self.blocks[n_lat](features[-1])
        pyramid = [x]
        for step, lateral in enumerate(reversed(laterals)):
            if self.weighted:
                x = self.fuses[step]([lateral, x])
                pyramid.append(x)
                continue
            narrow, merge = self._plan[step]
            if narrow is not None:
                x = self.blocks[narrow](x)
            up = self.upsamples[step](x)
            if self.fuse_fn == "concat":
                x = torch.cat([lateral, up], dim=1)
            else:
                x = lateral + up
            x = self.blocks[merge](x)
            pyramid.append(x)
        pyramid = pyramid[::-1]          # finest first
        return pyramid if return_pyramid else pyramid[0]


class BiFPN(nn.Module):
    """Bidirectional FPN with softmax-free weighted fusion (EfficientDet):
    1x1 ConvNormAct laterals to `out_channels` (`blocks`), then
    `num_repeats` rounds of a top-down and a bottom-up pass of `Fuse`
    nodes (`fuses`, in call order); the bottom-up nodes below the top
    also take the round's input level."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_repeats: int = 2, weighted: bool = True,
                 upsample_type: str = "nearest", conv_type: str = "normal"):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.out_channels = out_channels
        self.num_repeats = num_repeats
        n = len(self.in_channels)
        self.blocks = nn.ModuleList(ConvNormAct(c, out_channels, 1, act=None)
                                    for c in self.in_channels)

        def fuse(k):
            return Fuse((out_channels,) * k, out_channels, weighted=weighted,
                        upsample=upsample_type, conv_type=conv_type)

        fuses = []
        for _ in range(num_repeats):
            fuses += [fuse(2) for _ in range(n - 1)]                   # top-down
            fuses += [fuse(3 if i < n - 1 else 2) for i in range(1, n)]  # bottom-up
        self.fuses = nn.ModuleList(fuses)

    @property
    def stride(self) -> int:
        return 2 ** (len(self.in_channels) - 1)

    def forward(self, features: List[torch.Tensor],
                return_pyramid: bool = False):
        levels = [blk(f) for blk, f in zip(self.blocks, features)]
        n = len(levels)
        fuses = iter(self.fuses)
        for _ in range(self.num_repeats):
            td = [None] * n
            td[-1] = levels[-1]
            for i in range(n - 2, -1, -1):
                td[i] = next(fuses)([levels[i], td[i + 1]])
            bu = [None] * n
            bu[0] = td[0]
            for i in range(1, n):
                inputs = [td[i], bu[i - 1]]
                if i < n - 1:
                    inputs.append(levels[i])  # residual input edge
                bu[i] = next(fuses)(inputs)
            levels = bu
        return levels if return_pyramid else levels[0]


class IDA(nn.Module):
    """Iterative deep aggregation (DLA-style): fuse adjacent levels
    (`fuses`, in call order) until one finest-resolution map remains."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 weighted: bool = False, upsample_type: str = "nearest",
                 conv_type: str = "normal"):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.out_channels = out_channels
        widths = list(self.in_channels)
        fuses = []
        while len(widths) > 1:
            fuses += [Fuse((widths[i], widths[i + 1]), out_channels,
                           weighted=weighted, upsample=upsample_type,
                           conv_type=conv_type)
                      for i in range(len(widths) - 1)]
            widths = [out_channels] * (len(widths) - 1)
        self.fuses = nn.ModuleList(fuses)

    @property
    def stride(self) -> int:
        return 2 ** (len(self.in_channels) - 1)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        levels = list(features)
        fuses = iter(self.fuses)
        while len(levels) > 1:
            levels = [next(fuses)([levels[i], levels[i + 1]])
                      for i in range(len(levels) - 1)]
        return levels[0]


class IDAUp(nn.Module):
    """One iterative deep aggregation pass of CenterNet's DLA neck
    (xingyizhou/CenterNet `pose_dla_dcn.py:IDAUp`). For each input level
    i >= 1 of `in_channels`: `proj_i`, a 3x3 `conv_type` block to
    `out_channels`; `up_i`, a `DepthwiseUpsample` by `factors[i]`; and
    `node_i`, a 3x3 `conv_type` block over the sum with the level before
    it, each already at the finer resolution."""

    def __init__(self, out_channels: int, in_channels: Sequence[int],
                 factors: Sequence[int], conv_type: str):
        super().__init__()
        block = get_conv_block(conv_type)
        for i in range(1, len(in_channels)):
            setattr(self, f"proj_{i}", block(in_channels[i], out_channels, 3))
            setattr(self, f"up_{i}", DepthwiseUpsample(out_channels, factors[i]))
            setattr(self, f"node_{i}", block(out_channels, out_channels, 3))

    def forward(self, layers: List[torch.Tensor], start: int, end: int) -> None:
        """Aggregate layers[start:end] in place, as upstream: layers[i]
        becomes node_j(up_j(proj_j(layers[i])) + layers[i - 1]), j = i -
        start, for i from start + 1 up."""
        for i in range(start + 1, end):
            j = i - start
            up = getattr(self, f"up_{j}")(getattr(self, f"proj_{j}")(layers[i]))
            layers[i] = getattr(self, f"node_{j}")(up + layers[i - 1])


class DLAUp(nn.Module):
    """CenterNet's DLA-34 neck (arXiv:1904.07850; `pose_dla_dcn.py`'s
    `DLASeg` with down_ratio 4): upstream's `DLAUp(startp, channels,
    scales)` on the backbone's levels (`ida_0` .. `ida_{n-2}`, coarsest
    first), then the final `IDAUp(channels[0], channels[:-1], [1, 2, 4,
    ...])` (`ida_up`) over the finest n - 1 maps it returns. Each level
    has twice the stride of the one before. Returns the finest map
    (`in_channels[0]` wide, stride 4 on DLA-34); with DLA-34's [64, 128,
    256, 512] it holds 16 `conv_type` blocks, upstream's `DeformConv`
    (DCNv2, BatchNorm, ReLU) with `conv_type: dcn`. The whole forward is
    the span `neck.dlaup`."""

    def __init__(self, in_channels: Sequence[int], conv_type: str = "dcn"):
        super().__init__()
        channels = list(in_channels)
        n = len(channels)
        if n < 2:
            raise ValueError(f"DLAUp needs at least two levels, got {channels}")
        self.in_channels = tuple(channels)
        self.out_channels = channels[0]
        scales = [2 ** i for i in range(n)]
        widths = list(channels)
        for i in range(n - 1):
            j = n - 2 - i
            setattr(self, f"ida_{i}", IDAUp(channels[j], widths[j:],
                                            [s // scales[j] for s in scales[j:]],
                                            conv_type))
            scales[j + 1:] = [scales[j]] * (n - j - 1)
            widths[j + 1:] = [channels[j]] * (n - j - 1)
        self.ida_up = IDAUp(channels[0], channels[:-1],
                            [2 ** i for i in range(n - 1)], conv_type)

    @property
    def stride(self) -> int:
        return 2 ** (len(self.in_channels) - 1)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        with span("neck.dlaup"):
            layers = list(features)
            n = len(layers)
            out = [layers[-1]]
            for i in range(n - 1):
                getattr(self, f"ida_{i}")(layers, n - 2 - i, n)
                out.insert(0, layers[-1])
            y = out[:n - 1]
            self.ida_up(y, 0, n - 1)
            return y[-1]


NECKS = {
    "SimpleNeck": SimpleNeck,
    "simple": SimpleNeck,
    "FPN": FPN,
    "fpn": FPN,
    "BiFPN": BiFPN,
    "bifpn": BiFPN,
    "IDA": IDA,
    "ida": IDA,
    "DLAUp": DLAUp,
    "dlaup": DLAUp,
}


def build_neck(name: str, in_channels: Sequence[int], **kwargs):
    if name not in NECKS:
        raise KeyError(f"unknown neck '{name}'; available: {sorted(NECKS)}")
    cls = NECKS[name]
    if cls is not SimpleNeck and kwargs.get("upsample_channels"):
        # progressive-width FPN: out_channels is the emitted map's width
        kwargs = dict(kwargs)
        kwargs.setdefault("out_channels", tuple(kwargs["upsample_channels"])[-1])
        if cls in (BiFPN, IDA):
            # the repeated-fusion necks run at one width: upsample_channels
            # only supplies out_channels' default
            kwargs.pop("upsample_channels")
    return cls(in_channels=tuple(in_channels), **kwargs)
