"""The reference detector: backbone -> FPN -> heads, from a configuration's
`model` section, NHWC images in, NHWC maps out.

  backbone  reference/backbones/<name>.py, found by name;
  FPN       1x1 conv + BatchNorm laterals on the maps of strides 4-16 and
            the same on stride 32 (blocks 0-3), then from stride 16 down to
            4: x2 nearest upsample, sum with the lateral, and a 3x3 merge
            block (blocks 4-6): conv + BatchNorm + ReLU, or the bounded
            DCNv2 block for conv_type dcn_fast (d = 2) / dcn_fast_d<d>;
  heads     heatmap (num_classes logits) and box_2d (4): `depth` 3x3 conv +
            BatchNorm + ReLU blocks of `width`, then a 1x1 conv with bias.
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .nn import Ctx, conv, conv_bn_act, dcn_block

HEADS = ("heatmap", "box_2d")
STRIDE = 4           # the FPN emits the stride-4 map


def _displacement(conv_type: str):
    if conv_type == "normal":
        return None
    if conv_type == "dcn_fast":
        return 2
    if conv_type.startswith("dcn_fast_d"):
        return int(conv_type[len("dcn_fast_d"):])
    raise ValueError(f"the reference has no conv_type {conv_type!r}")


def _stage(ctx: Ctx, fn, x):
    if ctx.checkpoint and torch.is_grad_enabled() and ctx.spec is None:
        return checkpoint(lambda t: fn(ctx, t), x, use_reentrant=False)
    return fn(ctx, x)


def merge_block(ctx, name, x, width, d):
    if d is None:
        return conv_bn_act(ctx, name, x, width, 3)
    return dcn_block(ctx, name, x, width, d)


def fpn(ctx: Ctx, feats, cfg: Dict, prefix: str = "neck"):
    if cfg.get("fuse_fn", "sum") != "sum" or cfg.get("weighted") or \
            cfg.get("upsample_type", "nearest") != "nearest":
        raise ValueError(f"the reference FPN is the summing nearest one: {cfg}")
    width = cfg.get("out_channels", 256)
    d = _displacement(cfg.get("conv_type", "normal"))
    lat = [conv_bn_act(ctx, f"{prefix}.blocks.{i}", f, width, 1, act=None)
           for i, f in enumerate(feats[:-1])]
    x = conv_bn_act(ctx, f"{prefix}.blocks.{len(lat)}", feats[-1], width, 1,
                    act=None)
    for step, lateral in enumerate(reversed(lat)):
        name = f"{prefix}.blocks.{len(lat) + 1 + step}"

        def merge(ctx, x, lateral=lateral, name=name):
            up = F.interpolate(x, scale_factor=2, mode="nearest")
            return merge_block(ctx, name, lateral + up, width, d)

        x = _stage(ctx, merge, x)
    return x


def head(ctx: Ctx, name: str, x, cout: int, cfg: Dict):
    def run(ctx, x):
        for i in range(cfg.get("depth", 3)):
            x = conv_bn_act(ctx, f"{name}.blocks.{i}", x, cfg.get("width", 256), 3)
        return conv(ctx, f"{name}.out_conv", x, cout, 1, pad=0, bias=True,
                    kind="head_out")
    return _stage(ctx, run, x).permute(0, 2, 3, 1)


def preprocess(images: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW, (x - 255 mean) / (255 std)."""
    x = images.float()
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return ((x - m) / s).permute(0, 3, 1, 2)


def forward(ctx: Ctx, model_cfg: Dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """x: NCHW float32. Returns {heatmap, box_2d} NHWC logits / offsets."""
    bb = importlib.import_module(f"{__package__}.backbones.{model_cfg['backbone']}")
    fns, outs = bb.stages()
    feats = []
    for i, fn in enumerate(fns):
        x = _stage(ctx, fn, x)
        if i in outs:
            feats.append(x)
    y = fpn(ctx, feats, dict(model_cfg.get("neck_config") or {}))
    head_cfg = dict(model_cfg.get("head_config") or {})
    return {"heatmap": head(ctx, "heads.heatmap", y, model_cfg["num_classes"],
                            head_cfg),
            "box_2d": head(ctx, "heads.box_2d", y, 4, head_cfg)}


def param_spec(model_cfg: Dict, image_size) -> Dict[str, tuple]:
    """name -> (shape, kind) of every tensor of the model, in forward
    order, from a forward on meta tensors."""
    spec: Dict[str, tuple] = {}
    h, w = image_size
    forward(Ctx(spec=spec), model_cfg, torch.zeros((1, 3, h, w), device="meta"))
    return spec
