"""The reference detector: backbone -> neck -> heads, from a configuration's
`model` section, NHWC images in, NHWC maps out.

  backbone  reference/backbones/<backbone>.py, found by name:
            `stages(prefix="backbone")` returns (fns, outs), the stage
            functions fn(ctx, x) -> x in order and the indices of those
            whose maps feed the neck (strides 4 to 32); each stage is
            checkpointed on its own (nn.checkpoint_stage);
  neck      reference/necks/<neck in lower case>.py, found by name ("FPN"
            is necks/fpn.py): `forward(ctx, feats, neck_config,
            prefix="neck")` takes the backbone's maps and returns the
            stride-4 map; it checkpoints its own stages and raises
            ValueError for a key of neck_config it does not model;
  heads     heatmap (num_classes logits) and box_2d (4): `depth` 3x3
            blocks of `width` and `block` (nn.conv_block, as the program's
            models/heads.py:GenericHead), then a 1x1 conv with bias.

A 3x3 block's engine follows its `conv_type` (nn.conv_block): `normal`,
the exact DCNv2 (`dcn`, `deformable`) or the bounded DCNv2 (`dcn_fast`,
`dcn_fast_d<d>`, `dcn_fused_d<d>`). A key the reference does not model is
refused, never ignored: a model that is not the program's would be judged
against it.
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from .nn import Ctx, checkpoint_stage, conv, conv_block

STRIDE = 4           # the neck emits the stride-4 map
HEAD_KEYS = ("width", "depth", "block")
NOT_MODELLED = ("extra_block", "backbone_config", "reid_config")


def neck_module(name: str):
    """reference/necks/<name in lower case>.py."""
    module = f"{__package__}.necks.{name.lower()}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"the reference has no neck {name!r}: "
                         f"benchmark/reference/necks/{name.lower()}.py") from None


def head(ctx: Ctx, name: str, x, cout: int, cfg: Dict):
    unknown = sorted(set(cfg) - set(HEAD_KEYS))
    if unknown:
        raise ValueError(f"the reference head does not model {unknown}")
    block = cfg.get("block", "normal")

    def run(ctx, x):
        for i in range(cfg.get("depth", 3)):
            x = conv_block(ctx, f"{name}.blocks.{i}", x, cfg.get("width", 256), block)
        return conv(ctx, f"{name}.out_conv", x, cout, 1, pad=0, bias=True,
                    kind="head_out")
    return checkpoint_stage(ctx, run, x).permute(0, 2, 3, 1)


def preprocess(images: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW, (x - 255 mean) / (255 std)."""
    x = images.float()
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return ((x - m) / s).permute(0, 3, 1, 2)


def forward(ctx: Ctx, model_cfg: Dict, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """x: NCHW float32. Returns {heatmap, box_2d} NHWC logits / offsets."""
    for key in NOT_MODELLED:
        if model_cfg.get(key) is not None:
            raise ValueError(f"the reference does not model {key}: {model_cfg[key]!r}")
    neck = neck_module(model_cfg.get("neck", "FPN"))
    bb = importlib.import_module(f"{__package__}.backbones.{model_cfg['backbone']}")
    fns, outs = bb.stages()
    feats = []
    for i, fn in enumerate(fns):
        x = checkpoint_stage(ctx, fn, x)
        if i in outs:
            feats.append(x)
    y = neck.forward(ctx, feats, dict(model_cfg.get("neck_config") or {}), prefix="neck")
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
