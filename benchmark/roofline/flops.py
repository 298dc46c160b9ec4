"""Model FLOPs an image, counted once from shapes: torch's FlopCounterMode
over the reference's forward on meta tensors (convolutions and matrix
products; the DCN taps' products are 1x1 convolutions there). A training
step counts three forwards (the backward takes two), the usual convention
of model FLOP utilisation; recomputation is not counted."""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import model as model_ref
from reference.nn import Ctx


def forward_flops_per_image(model_cfg: Dict, image_size) -> int:
    spec: Dict = {}
    h, w = image_size
    with FlopCounterMode(display=False) as counter:
        model_ref.forward(Ctx(spec=spec), model_cfg,
                          torch.zeros((1, 3, h, w), device="meta"))
    return int(counter.get_total_flops())
