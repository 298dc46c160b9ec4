"""Model assembly: backbone -> [extra block] -> neck -> {name: head}
(port of models/meta.py).

`GenericModel.forward` keeps the JAX package's layout: NHWC images in,
NHWC head maps out. Inside it runs NCHW convolutions on a
`torch.channels_last` view, so the permutes at both ends move no bytes and
each head's NHWC output is contiguous.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from .backbones import build_backbone
from .backbones.efficientnet import SqueezeExciteSiLU
from .backbones.mobilenet import SqueezeExcite
from .backbones.vovnet import ESE
from .backbones.resnet import BasicBlock, Bottleneck
from .heads import GenericHead, ReIDClassifier
from .layers import (SPP, DeformableConvBlock, DepthwiseUpsample, Fuse, Upsample,
                     bilinear_filter, bilinear_kernel)
from .necks import build_neck

__all__ = ["GenericModel", "create_model", "init_weights", "param_count_report"]


class GenericModel(nn.Module):
    """State-dict keys start with `backbone.`, `neck.`, `heads.<name>.`,
    `extra_block.` and `classifier.`, the layout the JAX package's
    `torch_convert._split_by_prefix` reads. `extra_block` (an SPP, or
    None) runs on the coarsest backbone map before the neck; `classifier`
    (a ReIDClassifier, or None) is FairMOT's train-only identity
    classifier, which `forward` does not run."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 heads: Dict[str, nn.Module],
                 extra_block: Optional[nn.Module] = None,
                 classifier: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.heads = nn.ModuleDict(heads)
        self.extra_block = extra_block
        self.classifier = classifier

    def _features(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        features = self.backbone(x)
        if self.extra_block is not None:
            features = list(features)
            features[-1] = self.extra_block(features[-1])
        return features

    def _heads(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: head(x).permute(0, 2, 3, 1).contiguous()
                for name, head in self.heads.items()}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._heads(self.neck(self._features(x)))

    def classify_embeddings(self, embeddings: torch.Tensor) -> torch.Tensor:
        """ReID identity logits (M, max_track_ids) of (M, emb_dim)
        embeddings."""
        if self.classifier is None:
            raise ValueError("the model has no ReID classifier (reid_config)")
        return self.classifier(embeddings)

    def forward_with_classifier(self, x: torch.Tensor, indices: torch.Tensor
                                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The forward, the ReID embeddings gathered at (N, K) flat indices
        y*W + x, and their identity logits (N*K, max_track_ids), in one
        pass (batch statistics of the backbone and the classifier move
        together in train mode)."""
        from ..ops.decode import gather_at_indices

        out = self(x)
        emb = gather_at_indices(out["reid"], indices)      # (N, K, E)
        n, k, e = emb.shape
        return out, self.classify_embeddings(emb.reshape(n * k, e))

    def multilevel_forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """Every head on every level of the neck's pyramid, finest first;
        the neck must take `return_pyramid` (FPN, BiFPN)."""
        pyramid = self.neck(self._features(x), return_pyramid=True)
        return [self._heads(level) for level in pyramid]


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
    log(p / (1 - p)) for the prior p; the box head has 4 channels.
    `reid_config` adds FairMOT's embedding head `reid` (emb_dim channels,
    width 256 and depth 1 unless it says otherwise; its `loss_weight` and
    `loss_function` belong to the task) and the identity classifier over
    `max_track_ids`."""
    head_config = dict(head_config or {})
    bb = build_backbone(backbone, in_channels=input_channels,
                        **dict(backbone_config or {}))
    widths = list(bb.out_channels)
    if isinstance(extra_block, dict):
        eb = dict(extra_block)
        eb_name = eb.pop("name", eb.pop("type", "SPP"))
        if str(eb_name).upper() != "SPP":
            raise KeyError(f"unknown extra_block '{eb_name}' (available: SPP)")
        # out_channels defaults to the last stage's, so the neck's
        # contract is unchanged
        eb.setdefault("out_channels", widths[-1])
        extra_block = SPP(widths[-1], **eb)
    if extra_block is not None:
        widths[-1] = getattr(extra_block, "out_channels", widths[-1])
    nk = build_neck(neck, widths, **dict(neck_config or {}))
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
    classifier = None
    if reid_config is not None:
        rc = dict(reid_config)
        max_track_ids = rc.pop("max_track_ids", 1000)
        emb_dim = rc.pop("emb_dim", 64)
        rc.setdefault("width", 256)
        rc.setdefault("depth", 1)
        rc.pop("loss_weight", None)
        rc.pop("loss_function", None)  # the task's (FairMOT: ce | triplet)
        heads["reid"] = GenericHead(feat, emb_dim, **rc)
        classifier = ReIDClassifier(emb_dim, max_track_ids)
    return GenericModel(bb, nk, heads, extra_block=extra_block,
                        classifier=classifier), stride


def param_count_report(model: GenericModel) -> str:
    """Parameter counts in millions, one line a top-level submodule, named
    and ordered as the JAX package's report names its flax scopes
    (backbone, classifier, extra_block, heads_<name>, neck)."""
    parts = {f"heads_{name}": head for name, head in model.heads.items()}
    parts.update((name, child) for name, child in model.named_children()
                 if name != "heads")
    width = max(len(k) for k in parts) + 1
    lines = []
    for name in sorted(parts):
        n = sum(p.numel() for p in parts[name].parameters()) / 1e6
        lines.append(f"{name:{width}}: {n:.1f}M")
    return "\n".join(lines)


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
    convolutions (ConvBN, ConvBNSiLU and DLA's among them), lecun_normal
    for the residual projections, the head output convolutions and the
    squeeze-excite convolutions (MobileNet's and EfficientNet's SE,
    VoVNet's eSE: flax's default `nn.Conv`; zero biases),
    unit/zero BatchNorm with the last BN of each residual block zeroed,
    each head's constant output bias; linear layers lecun_normal with zero
    biases (flax Dense); a DCN block's offset and mask
    convolutions are zero and its deformable kernel he_normal over fan-in
    k^2 C; a transpose conv is the bilinear kernel, or he_normal over
    fan-in k^2 C_in; a depthwise upsample (DLA-34's neck) is the bilinear
    filter in every channel, as upstream's `fill_up_weights`; fusion
    weights are ones. Same distributions, not the same numbers: jax.random
    and torch differ."""
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            plain = name.endswith(("downsample.0", "out_conv"))
            _trunc_normal_fan_in(mod.weight, 1.0 if plain else 2.0, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            _trunc_normal_fan_in(mod.weight, 1.0, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
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
        elif isinstance(mod, (SqueezeExcite, SqueezeExciteSiLU)):
            for conv in (mod.reduce, mod.expand):
                _trunc_normal_fan_in(conv.weight, 1.0, generator)
        elif isinstance(mod, ESE):
            _trunc_normal_fan_in(mod.conv.weight, 1.0, generator)
        elif isinstance(mod, Upsample) and mod.method == "conv_transpose":
            w = mod.conv.weight                       # (in, out, k, k)
            if mod.init_bilinear:
                w.copy_(bilinear_kernel(w.shape[-1], w.shape[0])
                        .permute(2, 3, 0, 1))
            else:
                # fan-in k^2 C_in, flax's for the (k, k, in, out) kernel
                _trunc_normal_fan_in(w.transpose(0, 1), 2.0, generator)
        elif isinstance(mod, DepthwiseUpsample):
            mod.weight.copy_(bilinear_filter(mod.weight.shape[-1]).expand_as(mod.weight))
        elif isinstance(mod, Fuse) and mod.fuse_weights is not None:
            mod.fuse_weights.fill_(1.0)
