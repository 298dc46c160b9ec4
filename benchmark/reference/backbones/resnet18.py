"""ResNet-18: a 7x7 stride-2 stem (padding 3) with BatchNorm and ReLU, a
3x3 stride-2 max pool (padding 1), then four stages of two basic blocks of
64, 128, 256 and 512 filters; the first block of stages 2-4 has stride 2
and a 1x1 stride-2 projection with BatchNorm on its shortcut. Convolutions
pad k // 2, without bias. Returns the four stages' maps (strides 4-32)."""
from __future__ import annotations

import torch.nn.functional as F

from ..nn import bn, conv

WIDTHS = (64, 128, 256, 512)


def basic(ctx, name, x, filters, stride):
    y = F.relu(bn(ctx, f"{name}.bn1",
                  conv(ctx, f"{name}.conv1", x, filters, 3, stride, pad=1)))
    y = bn(ctx, f"{name}.bn2", conv(ctx, f"{name}.conv2", y, filters, 3, pad=1))
    if stride != 1 or x.shape[1] != filters:
        x = bn(ctx, f"{name}.downsample.1",
               conv(ctx, f"{name}.downsample.0", x, filters, 1, stride, pad=0))
    return F.relu(y + x)


def stem(ctx, x, prefix):
    x = F.relu(bn(ctx, f"{prefix}.bn1",
                  conv(ctx, f"{prefix}.conv1", x, 64, 7, 2, pad=3)))
    return F.max_pool2d(x, 3, 2, 1)


def layer(ctx, x, prefix, s, filters):
    for b in range(2):
        x = basic(ctx, f"{prefix}.layer{s + 1}.{b}", x, filters,
                  2 if s > 0 and b == 0 else 1)
    return x


def stages(prefix="backbone"):
    fns = [lambda ctx, x: stem(ctx, x, prefix)]
    for s, f in enumerate(WIDTHS):
        fns.append(lambda ctx, x, s=s, f=f: layer(ctx, x, prefix, s, f))
    return fns, [1, 2, 3, 4]
