"""The weights, drawn on the device from the seed in one call.

The reference lists the model's tensors (reference/model.py:param_spec);
every convolution's weight comes from one normal draw, scaled a tensor:
gain / sqrt(fan-in) with gain sqrt(2) before ReLU or mish, 1 for a head's
output convolution and for a DCN block's mask convolution, and OFFSET_GAIN
for its offset convolution, so that its offsets spread over about
+-1.4 pixels and about one in six passes the clamp. BatchNorm starts at
scale 1, shift 0, mean 0, variance 1; biases are 0 but the heatmap head's,
log(p / (1 - p)) for the configuration's prior. Serving cells then set
the running statistics from one train-mode pass of the reference over
`calibration` images of the cell's own kind (as a trained model's would
be), so that scores are spread and not saturated.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from reference import model as model_ref
from reference.nn import Ctx, bn_update, fan_in_std

OFFSET_GAIN = 1.0
GAINS = {"conv": math.sqrt(2.0), "head_out": 1.0, "dcn_mask": 1.0,
         "dcn_offset": OFFSET_GAIN}


def make(spec: Dict[str, tuple], model_cfg: Dict, seed: int,
         device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    drawn = [(k, shape, GAINS[kind]) for k, (shape, kind) in spec.items()
             if kind in GAINS]
    sizes = [math.prod(shape) for _, shape, _ in drawn]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([fan_in_std(shape, g) for _, shape, g in drawn], device=device),
        torch.tensor(sizes, device=device))
    flat.mul_(scale)
    params = {k: t.view(shape) for (k, shape, _), t in
              zip(drawn, torch.split(flat, sizes))}
    prior = float(model_cfg.get("heatmap_prior", 0.01))
    box_bias = float(model_cfg.get("box_init_bias") or 0.0)
    for k, (shape, kind) in spec.items():
        if k in params:
            continue
        if kind == "bn_count":
            params[k] = torch.zeros(shape, dtype=torch.long, device=device)
        elif kind in ("bn_weight", "bn_var"):
            params[k] = torch.ones(shape, device=device)
        elif kind == "head_out_bias" and k.startswith("heads.heatmap."):
            params[k] = torch.full(shape, math.log(prior / (1 - prior)), device=device)
        elif kind == "head_out_bias":
            params[k] = torch.full(shape, box_bias, device=device)
        else:
            params[k] = torch.zeros(shape, device=device)
    return params


@torch.no_grad()
def calibrate(params: Dict[str, torch.Tensor], model_cfg: Dict,
              images: torch.Tensor, mean, std) -> None:
    """Running statistics := one train-mode pass's batch statistics over
    `images` (uint8 NHWC on the device), in float32 without TF32."""
    with no_tf32():
        ctx = Ctx(params, mode="calibrate")
        model_ref.forward(ctx, model_cfg, model_ref.preprocess(images, mean, std))
    bn_update(params, ctx.stats, momentum=1.0)


class no_tf32:
    """float32 matrix products and convolutions in full float32."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def load_into(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy `params` into the program's model, every tensor by name; the
    program's layout has to be the reference's, key for key."""
    state = model.state_dict()
    if set(state) != set(params):
        missing = sorted(set(params) - set(state))[:5]
        extra = sorted(set(state) - set(params))[:5]
        raise KeyError(f"the program's tensors differ from the reference's: "
                       f"missing {missing}, extra {extra}")
    model.load_state_dict({k: params[k] for k in state}, strict=True, assign=False)
