"""FPN, summing and nearest (the program's models/necks.py:FPN with
fuse_fn sum): 1x1 conv + BatchNorm laterals on the maps of strides 4-16
and the same on stride 32 (blocks 0-3), then from stride 16 down to 4: x2
nearest upsample, sum with the lateral, and a 3x3 merge block of
`conv_type` (blocks 4-6, nn.conv_block). Returns the stride-4 map."""
from __future__ import annotations

from typing import Dict

import torch.nn.functional as F

from ..nn import Ctx, checkpoint_stage, conv_bn_act, conv_block

MODELLED = ("out_channels", "fuse_fn", "weighted", "upsample_type", "conv_type")


def forward(ctx: Ctx, feats, cfg: Dict, prefix: str = "neck"):
    unknown = sorted(set(cfg) - set(MODELLED))
    if unknown:
        raise ValueError(f"the reference FPN does not model {unknown}")
    if cfg.get("fuse_fn", "sum") != "sum" or cfg.get("weighted") or \
            cfg.get("upsample_type", "nearest") != "nearest":
        raise ValueError(f"the reference FPN is the summing nearest one: {cfg}")
    width = cfg.get("out_channels", 256)
    conv_type = cfg.get("conv_type", "normal")
    lat = [conv_bn_act(ctx, f"{prefix}.blocks.{i}", f, width, 1, act=None)
           for i, f in enumerate(feats[:-1])]
    x = conv_bn_act(ctx, f"{prefix}.blocks.{len(lat)}", feats[-1], width, 1,
                    act=None)
    for step, lateral in enumerate(reversed(lat)):
        name = f"{prefix}.blocks.{len(lat) + 1 + step}"

        def merge(ctx, x, lateral=lateral, name=name):
            up = F.interpolate(x, scale_factor=2, mode="nearest")
            return conv_block(ctx, name, lateral + up, width, conv_type)

        x = checkpoint_stage(ctx, merge, x)
    return x
