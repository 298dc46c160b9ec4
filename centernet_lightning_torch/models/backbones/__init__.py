"""Backbone registry (port of models/backbones/__init__.py).

VoVNet, DLA and EfficientNet raise NotImplementedError until the slice
that ports them (ROADMAP Queue 1 item 2b).
"""
from .darknet import CSPDarknet53, cspdarknet53, darknet53
from .mobilenet import (MobileNetV2, MobileNetV3Large, MobileNetV3Small,
                        mobilenet_v2, mobilenet_v3_large, mobilenet_v3_small)
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101

BACKBONES = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "mobilenet_v2": mobilenet_v2,
    "mobilenetv2": mobilenet_v2,
    "mobilenet_v3_large": mobilenet_v3_large,
    "mobilenetv3_large": mobilenet_v3_large,
    "mobilenet_v3_small": mobilenet_v3_small,
    "mobilenetv3_small": mobilenet_v3_small,
    "cspdarknet53": cspdarknet53,
    "darknet53": darknet53,
}

_LATER = (
    "vovnet19", "vovnet39", "vovnet57", "dla34", "dla34_small",
    "efficientnet_b0", "efficientnet_b1", "efficientnet_b2", "efficientnet_b3",
)


def build_backbone(name: str, **kwargs):
    """Instantiate a backbone by registry name."""
    if name in _LATER:
        raise NotImplementedError(
            f"backbone {name!r} is ported with the remaining backbones "
            f"(ROADMAP Queue 1 item 2b)")
    if name not in BACKBONES:
        raise KeyError(f"unknown backbone '{name}'; available: {sorted(BACKBONES)}")
    return BACKBONES[name](**kwargs)


__all__ = ["BACKBONES", "CSPDarknet53", "MobileNetV2", "MobileNetV3Large",
           "MobileNetV3Small", "ResNet", "build_backbone", "cspdarknet53",
           "darknet53", "mobilenet_v2", "mobilenet_v3_large",
           "mobilenet_v3_small", "resnet18", "resnet34", "resnet50",
           "resnet101"]
