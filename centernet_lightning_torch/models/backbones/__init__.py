"""Backbone registry (port of models/backbones/__init__.py).

This slice ports the ResNets; the other families raise NotImplementedError
until the slice that ports them.
"""
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101

BACKBONES = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
}

_LATER = (
    "mobilenet_v2", "mobilenetv2", "mobilenet_v3_large", "mobilenetv3_large",
    "mobilenet_v3_small", "mobilenetv3_small", "cspdarknet53", "darknet53",
    "vovnet19", "vovnet39", "vovnet57", "dla34", "dla34_small",
    "efficientnet_b0", "efficientnet_b1", "efficientnet_b2", "efficientnet_b3",
)


def build_backbone(name: str, **kwargs):
    """Instantiate a backbone by registry name."""
    if name in _LATER:
        raise NotImplementedError(
            f"backbone {name!r} is ported with the remaining backbones "
            f"(ROADMAP Queue 1 item 8)")
    if name not in BACKBONES:
        raise KeyError(f"unknown backbone '{name}'; available: {sorted(BACKBONES)}")
    return BACKBONES[name](**kwargs)


__all__ = ["BACKBONES", "ResNet", "build_backbone",
           "resnet18", "resnet34", "resnet50", "resnet101"]
