"""Model assembly: backbone -> neck -> {name: head} (port of models/meta.py).

`GenericModel.forward` keeps the JAX package's layout: NHWC images in,
NHWC head maps out. Inside it runs NCHW convolutions on a
`torch.channels_last` view, so the permutes at both ends move no bytes and
each head's NHWC output is contiguous.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .backbones import build_backbone
from .backbones.resnet import BasicBlock, Bottleneck
from .heads import GenericHead
from .layers import DeformableConvBlock
from .necks import build_neck

__all__ = ["GenericModel", "create_model", "init_weights"]


class GenericModel(nn.Module):
    """State-dict keys start with `backbone.`, `neck.` and `heads.<name>.`,
    the layout the JAX package's `torch_convert._split_by_prefix` reads."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 heads: Dict[str, nn.Module]):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.heads = nn.ModuleDict(heads)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        out = self.neck(self.backbone(x))
        return {name: head(out).permute(0, 2, 3, 1).contiguous()
                for name, head in self.heads.items()}


def create_model(
    num_classes: int,
    backbone: str,
    neck: str = "FPN",
    neck_config: Optional[Dict[str, Any]] = None,
    head_config: Optional[Dict[str, Any]] = None,
    heatmap_prior: float = 0.01,
    box_init_bias: Optional[float] = None,
    backbone_config: Optional[Dict[str, Any]] = None,
    reid_config: Optional[Dict[str, Any]] = None,
    extra_block: Any = None,
    input_channels: int = 3,
) -> Tuple[GenericModel, int]:
    """Build the detection model. Returns (model, stride), with stride =
    backbone.stride // neck.stride. The heatmap head's bias is
    log(p / (1 - p)) for the prior p; the box head has 4 channels."""
    if reid_config is not None:
        raise NotImplementedError(
            "reid heads are ported with the tracking slice "
            "(ROADMAP Queue 1 item 10)")
    if extra_block is not None:
        raise NotImplementedError(
            "extra blocks (SPP) are ported with the remaining necks and "
            "blocks (ROADMAP Queue 1 item 8)")
    head_config = dict(head_config or {})
    bb = build_backbone(backbone, in_channels=input_channels,
                        **dict(backbone_config or {}))
    nk = build_neck(neck, bb.out_channels, **dict(neck_config or {}))
    stride = bb.stride // nk.stride

    feat = nk.out_channels
    heads = {
        "heatmap": GenericHead(
            feat, num_classes,
            init_bias=math.log(heatmap_prior / (1 - heatmap_prior)),
            **head_config),
        "box_2d": GenericHead(feat, 4, init_bias=box_init_bias,
                              **head_config),
    }
    return GenericModel(bb, nk, heads), stride


def _trunc_normal_fan_in(weight: torch.Tensor, scale: float,
                         generator: torch.Generator) -> None:
    """flax variance_scaling(scale, "fan_in", "truncated_normal")."""
    fan_in = weight.shape[1] * weight[0, 0].numel()
    # 0.8796...: the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


@torch.no_grad()
def init_weights(model: GenericModel, generator: torch.Generator) -> None:
    """The JAX package's initialisers, drawn from `generator`: he_normal
    convolutions, lecun_normal for the residual projections and the head
    output convolutions, unit/zero BatchNorm with the last BN of each
    residual block zeroed, and each head's constant output bias; a DCN
    block's offset and mask convolutions are zero and its deformable
    kernel he_normal over fan-in k^2 C. Same distributions, not the same
    numbers: jax.random and torch differ."""
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            plain = name.endswith(("downsample.0", "out_conv"))
            _trunc_normal_fan_in(mod.weight, 1.0 if plain else 2.0, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    for mod in model.modules():
        if isinstance(mod, BasicBlock):
            mod.bn2.weight.zero_()
        elif isinstance(mod, Bottleneck):
            mod.bn3.weight.zero_()
        elif isinstance(mod, GenericHead) and mod.init_bias is not None:
            mod.out_conv.bias.fill_(mod.init_bias)
        elif isinstance(mod, DeformableConvBlock):
            for conv in (mod.conv_offset, mod.conv_mask):
                if conv is not None:
                    conv.weight.zero_()
                    conv.bias.zero_()
            _trunc_normal_fan_in(mod.deform.weight, 2.0, generator)
