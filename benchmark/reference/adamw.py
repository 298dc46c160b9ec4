"""AdamW as optax applies it (b1 0.9, b2 0.999, eps 1e-8 outside the
root, bias corrections 1 - b^t in float32, decoupled weight decay added to
the step before the learning rate), with the warm-up of the recipe:
lr_t = lr (warmup_decay + (1 - warmup_decay) t / (warmup_epochs x
steps_per_epoch)) for the first updates. Weight decay `weight_decay` on
every tensor but BatchNorm's scale and bias (`norm_weight_decay`)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class AdamW:
    def __init__(self, opt_cfg: Dict, steps_per_epoch: int, norm_names):
        if opt_cfg.get("optimizer", "AdamW").lower() != "adamw":
            raise ValueError("the reference optimizer is AdamW")
        self.lr = float(opt_cfg["lr"])
        self.wd = float(opt_cfg.get("weight_decay", 0.0))
        self.norm_wd = float(opt_cfg.get("norm_weight_decay", 0.0) or 0.0)
        self.warm_steps = int(opt_cfg.get("warmup_epochs", 5)) * int(steps_per_epoch)
        self.warm_decay = float(opt_cfg.get("warmup_decay", 0.01))
        self.norm = set(norm_names)
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def lr_at(self, t: int) -> float:
        if t >= self.warm_steps:
            raise ValueError("the reference follows the warm-up only")
        f32 = np.float32
        frac = f32(t) / f32(self.warm_steps)
        return float(f32(self.lr * (self.warm_decay + (1.0 - self.warm_decay) * frac)))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        lr = self.lr_at(self.count)
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(0.9) ** f32(self.count))
        bc2 = float(f32(1) - f32(0.999) ** f32(self.count))
        for name, g in grads.items():
            p = params[name]
            mu = 0.1 * g + 0.9 * self.mu.get(name, torch.zeros_like(g))
            nu = 0.001 * g * g + 0.999 * self.nu.get(name, torch.zeros_like(g))
            self.mu[name], self.nu[name] = mu, nu
            wd = self.norm_wd if name in self.norm else self.wd
            p.sub_(lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8) + wd * p))
