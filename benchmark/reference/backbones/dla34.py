"""DLA-34 (Yu et al., "Deep Layer Aggregation", arXiv:1707.06484, as
xingyizhou/CenterNet `pose_dla_dcn.py:dla34` builds it): a 7x7 stride-1
base conv of 16 with BatchNorm and ReLU, two conv levels (3x3, 16 at
stride 1, then 32 at stride 2), then four hierarchical aggregation trees
of 64, 128, 256 and 512 filters at stride 2 and depths 1, 2, 2, 1.

A tree of depth 1 runs two basic blocks (3x3 conv, BatchNorm, ReLU, 3x3
conv, BatchNorm, + residual, ReLU; the first strided, its residual the
input max-pooled by the stride and, where the width changes, projected by
a 1x1 conv and BatchNorm; the second's residual its input) and a root:
the concatenation of [second, first, children...] through a 1x1 conv,
BatchNorm and ReLU. A deeper tree runs two subtrees, the first's output
among the second's root children. Trees after the first are level roots:
their pooled input joins the root's children. A deeper tree also projects
its pooled input and drops the result (its subtrees project for
themselves): the parameters exist and, in train mode, the BatchNorm's
statistics move. Convolutions pad k // 2, without bias. Returns the four
trees' maps (strides 4-32)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn import bn, conv

CHANNELS = (16, 32, 64, 128, 256, 512)
LEVELS = (1, 1, 1, 2, 2, 1)


def conv_bn(ctx, conv_name, bn_name, x, filters, k, stride=1):
    return bn(ctx, bn_name, conv(ctx, conv_name, x, filters, k, stride, pad=k // 2))


def basic(ctx, name, x, filters, stride, residual):
    y = F.relu(conv_bn(ctx, f"{name}.conv1", f"{name}.bn1", x, filters, 3, stride))
    return F.relu(conv_bn(ctx, f"{name}.conv2", f"{name}.bn2", y, filters, 3) + residual)


def tree(ctx, name, x, levels, filters, stride, level_root=False, children=()):
    children = list(children)
    bottom = F.max_pool2d(x, stride, stride) if stride > 1 else x
    residual = bottom
    if x.shape[1] != filters:
        residual = conv_bn(ctx, f"{name}.project_conv", f"{name}.project_bn", bottom,
                           filters, 1)
    if level_root:
        children.append(bottom)
    if levels == 1:
        x1 = basic(ctx, f"{name}.tree1", x, filters, stride, residual)
        x2 = basic(ctx, f"{name}.tree2", x1, filters, 1, x1)
        return F.relu(conv_bn(ctx, f"{name}.root.conv", f"{name}.root.bn",
                              torch.cat([x2, x1] + children, dim=1), filters, 1))
    x1 = tree(ctx, f"{name}.tree1", x, levels - 1, filters, stride)
    return tree(ctx, f"{name}.tree2", x1, levels - 1, filters, 1, children=children + [x1])


def stem(ctx, x, prefix):
    x = F.relu(conv_bn(ctx, f"{prefix}.base_conv", f"{prefix}.base_bn", x, CHANNELS[0], 7))
    for level, stride in ((0, 1), (1, 2)):
        for i in range(LEVELS[level]):
            x = F.relu(conv_bn(ctx, f"{prefix}.level{level}_conv{i}",
                               f"{prefix}.level{level}_bn{i}", x, CHANNELS[level], 3,
                               stride if i == 0 else 1))
    return x


def stages(prefix="backbone"):
    fns = [lambda ctx, x: stem(ctx, x, prefix)]
    for i in range(2, 6):
        fns.append(lambda ctx, x, i=i: tree(ctx, f"{prefix}.level{i}", x, LEVELS[i],
                                            CHANNELS[i], 2, level_root=i > 2))
    return fns, [1, 2, 3, 4]
