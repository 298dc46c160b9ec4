"""CSPDarknet-53 (YOLOv4): a 3x3 stem of 32, then five CSP stages of
64, 128, 256, 512 and 1024 filters with 1, 2, 8, 8 and 4 residual blocks.
A stage: a 3x3 stride-2 conv, two 1x1 splits, the residual blocks on one
(1x1 then 3x3, added to their input), a 1x1 closing it, the concatenation
with the other split and a 1x1 fuse. The first stage keeps full width in
both splits and halves the residual blocks' hidden width. Every conv is
SAME, without bias, then BatchNorm and mish. Returns the maps of stages
2-5 (strides 4, 8, 16, 32)."""
from __future__ import annotations

import torch

from ..nn import conv_bn_act, mish

STEM = 32
FILTERS = (64, 128, 256, 512, 1024)
BLOCKS = (1, 2, 8, 8, 4)


def dark(ctx, name, x, cout, k, stride=1):
    return conv_bn_act(ctx, name, x, cout, k, stride, act=mish)


def stage(ctx, name, x, filters, blocks, first):
    split = filters if first else filters // 2
    hidden = filters // 2 if first else split
    x = dark(ctx, f"{name}.convs.0", x, filters, 3, 2)
    main = dark(ctx, f"{name}.convs.1", x, split, 1)
    short = dark(ctx, f"{name}.convs.2", x, split, 1)
    for b in range(blocks):
        h = dark(ctx, f"{name}.blocks.{b}.convs.0", main, hidden, 1)
        main = main + dark(ctx, f"{name}.blocks.{b}.convs.1", h, split, 3)
    main = dark(ctx, f"{name}.convs.3", main, split, 1)
    return dark(ctx, f"{name}.convs.4", torch.cat([main, short], dim=1),
                filters, 1)


def stages(prefix="backbone"):
    """The backbone as a list of callables x -> x, and the indices whose
    outputs are the features."""
    fns = [lambda ctx, x: dark(ctx, f"{prefix}.convs.0", x, STEM, 3)]
    for i, (f, b) in enumerate(zip(FILTERS, BLOCKS)):
        fns.append(lambda ctx, x, i=i, f=f, b=b:
                   stage(ctx, f"{prefix}.blocks.{i}", x, f, b, i == 0))
    return fns, [2, 3, 4, 5]
