"""The reference training steps: float32 forward in train mode (batch
statistics), the loss, the gradient, AdamW, and the running statistics
moved after each step (momentum 0.1, biased variance)."""
from __future__ import annotations

from typing import Dict, List

import torch

from . import loss as loss_ref
from . import model as model_ref
from .adamw import AdamW
from .nn import Ctx, bn_update


def train_steps(model_cfg: Dict, params: Dict[str, torch.Tensor],
                batches: List[Dict[str, torch.Tensor]], opt: AdamW, mean, std,
                stride: int, lowp=None, checkpoint: bool = True) -> Dict:
    """Runs len(batches) steps in place on `params` (float32 copies).
    Returns {losses: [float], grad_norms: {name: float} of the first step}."""
    trainable = [k for k in params if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    losses, grad_norms = [], None
    for batch in batches:
        leaves = {k: params[k].detach().requires_grad_() for k in trainable}
        ctx = Ctx(dict(params, **leaves), mode="train", lowp=lowp,
                  checkpoint=checkpoint)
        x = model_ref.preprocess(batch["image"], mean, std)
        out = model_ref.forward(ctx, model_cfg, x)
        total = loss_ref.detection_loss(out, batch, model_cfg, stride)["total"]
        grads = torch.autograd.grad(total, [leaves[k] for k in trainable])
        grads = dict(zip(trainable, grads))
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        losses.append(float(total.detach()))
        opt.step(params, grads)
        bn_update(params, ctx.stats)
        params_nbt = [k for k in params if k.endswith("num_batches_tracked")]
        for k in params_nbt:
            params[k] += 1
        del out, total, grads, leaves, ctx
    return {"losses": losses, "grad_norms": grad_norms}
