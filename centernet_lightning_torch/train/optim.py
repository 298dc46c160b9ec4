"""Optimizer and learning-rate schedules with optax's semantics (port of
train/optim.py).

The JAX package builds an optax chain; this module applies the same update
rules to the model's parameters, named as in its `state_dict`:
  - SGD (momentum 0.9), Adam and RMSprop take coupled weight decay
    (optax `add_decayed_weights` chained before them); AdamW's decay is
    decoupled (added to Adam's step, then scaled by the learning rate);
  - RMSprop is optax's: decay 0.9, eps inside the square root, then the
    learning rate, then momentum (torch's RMSprop differs in all three);
  - parameter groups: norm parameters take `norm_weight_decay`; the
    backbone stages that `frozen_stages` freezes take zero updates, decay
    included. Both are found by module type and by the ResNet's stages,
    not by name;
  - `gradient_clip_val`: optax `clip_by_global_norm` over every gradient,
    before everything else;
  - over several processes the gradients are first averaged over them
    (`parallel.dist.mean_gradients`, one flat all-reduce an update, over
    the data group on a 2-D grid); the clip's norm counts a parameter that
    parallel/mesh.py splits over a model group once, summing its slices'
    squares over that group;
  - schedules: LinearLR warmup then cosine, or OneCycleLR with momentum
    (Adam's beta1) cycling, evaluated in float32 as the JAX package does;
  - `MultiSteps`: optax.MultiSteps, the mean of k micro-batch gradients
    applied every k-th step.
Updates are in place, under no_grad.
"""
from __future__ import annotations

import inspect
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..parallel import dist

__all__ = ["Optimizer", "MultiSteps", "make_optimizer", "make_lr_schedule",
           "make_onecycle_schedule", "make_onecycle_momentum_schedule",
           "resolve_schedules", "schedule_from_config",
           "param_labels"]

_F32 = np.float32


# ---- schedules (step -> float32) ------------------------------------------

def make_lr_schedule(lr: float, max_epochs: int, steps_per_epoch: int,
                     warmup_epochs: int = 5, warmup_decay: float = 0.01
                     ) -> Callable[[int], np.float32]:
    """LinearLR(start_factor=warmup_decay) for the warmup epochs, then
    CosineAnnealingLR over the rest, per step."""
    warmup_steps = warmup_epochs * steps_per_epoch
    cosine_steps = max(1, (max_epochs - warmup_epochs) * steps_per_epoch)

    def schedule(step):
        step = _F32(step)
        t = np.clip((step - warmup_steps) / _F32(cosine_steps), 0.0, 1.0)
        cos = lr * 0.5 * (1.0 + np.cos(_F32(math.pi) * t))
        if not warmup_steps:
            return _F32(cos)
        warm_frac = np.clip(step / _F32(warmup_steps), 0.0, 1.0)
        warm = lr * (warmup_decay + (1.0 - warmup_decay) * warm_frac)
        return _F32(warm if step < warmup_steps else cos)

    return schedule


def _onecycle_phase_fn(phases, anneal_strategy: str):
    """torch OneCycleLR's phase walk: phase i spans (prev_end, end] and
    anneals start -> end over pct = (step - start) / (end - start)."""
    if anneal_strategy not in ("cos", "linear"):
        raise ValueError(f"anneal_strategy must be 'cos' or 'linear', got "
                         f"{anneal_strategy!r}")

    def anneal(start, end, pct):
        if anneal_strategy == "linear":
            return start + (end - start) * pct
        return end + (start - end) * 0.5 * (1.0 + np.cos(_F32(math.pi) * pct))

    def schedule(step):
        s = _F32(step)
        out = None
        start_step = 0.0
        for end_step, v0, v1 in phases:
            span = _F32(max(end_step - start_step, 1e-8))
            val = anneal(v0, v1, np.clip((s - _F32(start_step)) / span, 0.0, 1.0))
            out = val if out is None or s > start_step else out
            start_step = end_step
        return _F32(out)

    return schedule


def _onecycle_boundaries(total_steps: float, pct_start: float,
                         three_phase: bool):
    if three_phase:
        return [max(float(pct_start * total_steps) - 1.0, 1e-8),
                max(float(2 * pct_start * total_steps) - 2.0, 2e-8),
                max(float(total_steps) - 1.0, 3e-8)]
    return [max(float(pct_start * total_steps) - 1.0, 1e-8),
            max(float(total_steps) - 1.0, 2e-8)]


def make_onecycle_schedule(max_lr: float, total_steps: int,
                           pct_start: float = 0.3, div_factor: float = 25.0,
                           final_div_factor: float = 1e4,
                           anneal_strategy: str = "cos",
                           three_phase: bool = False):
    """OneCycleLR's learning-rate curve; `step` counts optimizer updates."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    ends = _onecycle_boundaries(total_steps, pct_start, three_phase)
    if three_phase:
        phases = [(ends[0], initial_lr, max_lr), (ends[1], max_lr, initial_lr),
                  (ends[2], initial_lr, min_lr)]
    else:
        phases = [(ends[0], initial_lr, max_lr), (ends[1], max_lr, min_lr)]
    return _onecycle_phase_fn(phases, anneal_strategy)


def make_onecycle_momentum_schedule(total_steps: int, pct_start: float = 0.3,
                                    base_momentum: float = 0.85,
                                    max_momentum: float = 0.95,
                                    anneal_strategy: str = "cos",
                                    three_phase: bool = False):
    """OneCycleLR's cycle_momentum curve, inverse to the learning rate."""
    ends = _onecycle_boundaries(total_steps, pct_start, three_phase)
    if three_phase:
        phases = [(ends[0], max_momentum, base_momentum),
                  (ends[1], base_momentum, max_momentum),
                  (ends[2], max_momentum, max_momentum)]
    else:
        phases = [(ends[0], max_momentum, base_momentum),
                  (ends[1], base_momentum, max_momentum)]
    return _onecycle_phase_fn(phases, anneal_strategy)


_ONECYCLE_LR_KEYS = {"max_lr", "total_steps", "pct_start", "div_factor",
                     "final_div_factor", "anneal_strategy", "three_phase"}
_ONECYCLE_MOMENTUM_KEYS = {"cycle_momentum", "base_momentum", "max_momentum"}
_ONECYCLE_SPAN_KEYS = {"epochs", "steps_per_epoch"}


def resolve_schedules(lr: float, max_epochs: int, steps_per_epoch: int,
                      warmup_epochs: int = 5, warmup_decay: float = 0.01,
                      lr_scheduler: Optional[Dict[str, Any]] = None):
    """(step -> lr, step -> momentum or None) from an optional Gen-A
    `lr_scheduler` config {name, params}; the default is warmup + cosine
    with constant momentum."""
    name = (lr_scheduler or {}).get("name", "").lower()
    params = dict((lr_scheduler or {}).get("params") or {})
    if name in ("", "cosineannealinglr", "cosine"):
        return make_lr_schedule(lr, max_epochs, steps_per_epoch,
                                warmup_epochs, warmup_decay), None
    if name in ("onecyclelr", "one_cycle", "onecycle"):
        unknown = (set(params) - _ONECYCLE_LR_KEYS - _ONECYCLE_MOMENTUM_KEYS
                   - _ONECYCLE_SPAN_KEYS)
        if unknown:
            raise ValueError(
                f"unsupported OneCycleLR params {sorted(unknown)}; supported: "
                f"{sorted(_ONECYCLE_LR_KEYS | _ONECYCLE_MOMENTUM_KEYS | _ONECYCLE_SPAN_KEYS)}")
        params.setdefault("max_lr", lr)
        if "total_steps" not in params:
            params["total_steps"] = (params.get("epochs", max_epochs)
                                     * params.get("steps_per_epoch",
                                                  steps_per_epoch))
        params.pop("epochs", None)
        params.pop("steps_per_epoch", None)
        cycle_momentum = params.pop("cycle_momentum", True)
        mom_kwargs = {k: params.pop(k) for k in ("base_momentum", "max_momentum")
                      if k in params}
        lr_fn = make_onecycle_schedule(**params)
        mom_fn = None
        if cycle_momentum:
            mom_fn = make_onecycle_momentum_schedule(
                params["total_steps"], pct_start=params.get("pct_start", 0.3),
                anneal_strategy=params.get("anneal_strategy", "cos"),
                three_phase=params.get("three_phase", False), **mom_kwargs)
        return lr_fn, mom_fn
    raise KeyError(f"unknown lr_scheduler '{name}' "
                   "(known: CosineAnnealingLR, OneCycleLR)")


def schedule_from_config(opt_cfg: Dict[str, Any], max_epochs: int,
                         steps_per_epoch: int):
    """The learning-rate schedule `make_optimizer(**opt_cfg)` builds, for
    logging; defaults are read off make_optimizer's signature."""
    sig = inspect.signature(make_optimizer).parameters

    def get(key):
        return opt_cfg.get(key, sig[key].default)

    return resolve_schedules(get("lr"), max_epochs, steps_per_epoch,
                             get("warmup_epochs"), get("warmup_decay"),
                             get("lr_scheduler"))[0]


# ---- parameter groups -----------------------------------------------------

_NORMS = (nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm)


def param_labels(model: nn.Module, frozen_stages: int = 0) -> Dict[str, str]:
    """Each parameter's group: "frozen" for the backbone's stem and first
    `frozen_stages` stages (the whole backbone at 4 or more when it has no
    stages), "norm" for a normalisation layer's scale and bias, else
    "main"."""
    frozen = set()
    backbone = getattr(model, "backbone", None)
    if frozen_stages > 0 and backbone is not None:
        if hasattr(backbone, "stages"):
            mods = [m for stage in backbone.stages()[:frozen_stages + 1]
                    for m in stage]
        else:
            mods = [backbone] if frozen_stages >= 4 else []
        frozen = {id(p) for m in mods for p in m.parameters()}
    norm = {id(p) for m in model.modules() if isinstance(m, _NORMS)
            for p in m.parameters(recurse=False)}
    return {name: ("frozen" if id(p) in frozen else
                   "norm" if id(p) in norm else "main")
            for name, p in model.named_parameters()}


# ---- the update -----------------------------------------------------------

class Optimizer:
    """One of SGD / Adam / AdamW / RMSprop with optax's update rules over
    labelled parameters. `update(params, grads)` applies one step in place
    to the tensors of `params` (name -> tensor); `state_dict` and
    `load_state_dict` carry the step count and the moments."""

    def __init__(self, rule: str, labels: Dict[str, str],
                 weight_decay: Dict[str, float], lr_fn, momentum_fn=None,
                 momentum: Optional[float] = 0.9,
                 gradient_clip_val: Optional[float] = None):
        rule = rule.lower()
        if rule not in ("sgd", "adam", "adamw", "rmsprop"):
            raise KeyError(f"unknown optimizer '{rule}'")
        self.rule = rule
        self.labels = dict(labels)
        self.weight_decay = dict(weight_decay)
        self.lr_fn = lr_fn
        self.momentum_fn = momentum_fn
        self.momentum = momentum
        self.clip = gradient_clip_val
        self.count = 0
        self.slots: Dict[str, Dict[str, torch.Tensor]] = {}

    def _hyper(self):
        """(lr, momentum) at the current count; the momentum is Adam's b1
        for Adam and AdamW (0.9 unless OneCycleLR cycles it). Scheduled
        values are float32, as optax evaluates them."""
        lr = float(_F32(self.lr_fn(self.count)))
        if self.momentum_fn is not None:
            return lr, float(_F32(self.momentum_fn(self.count)))
        return lr, (0.9 if self.rule in ("adam", "adamw") else self.momentum)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        # over several processes the update sees the global batch's
        # gradient, as optax does under the data-parallel jit: the mean
        # comes before the clip, once an update (after MultiSteps' mean)
        grads = dist.mean_gradients(grads)
        if self.clip:
            g_norm = torch.sqrt(_squared_norm(params, grads))
            keep = g_norm < self.clip
            grads = {k: torch.where(keep, g, (g / g_norm) * self.clip)
                     for k, g in grads.items()}
        lr, mom = self._hyper()
        count = self.count + 1
        for name, p in params.items():
            label = self.labels[name]
            if label == "frozen":
                continue
            g, wd = grads[name], self.weight_decay[label]
            slot = self.slots.setdefault(name, {})
            if self.rule == "sgd":
                step = -lr * self._trace(slot, g + wd * p, mom)
            elif self.rule in ("adam", "adamw"):
                u = g + wd * p if self.rule == "adam" else g
                b1, b2 = mom, 0.999
                mu = (1 - b1) * u + b1 * slot.get("mu", torch.zeros_like(u))
                nu = (1 - b2) * u ** 2 + b2 * slot.get("nu", torch.zeros_like(u))
                slot["mu"], slot["nu"] = mu, nu
                step = ((mu / _bias_correction(b1, count))
                        / (torch.sqrt(nu / _bias_correction(b2, count)) + 1e-8))
                if self.rule == "adamw":
                    step = step + wd * p
                step = -lr * step
            else:  # rmsprop: decay 0.9, eps inside the root, then momentum
                u = g + wd * p
                nu = 0.1 * u ** 2 + 0.9 * slot.get("nu", torch.zeros_like(u))
                slot["nu"] = nu
                step = self._trace(slot, -lr * (torch.rsqrt(nu + 1e-8) * u), mom)
            p.add_(step)
        self.count = count

    @staticmethod
    def _trace(slot, u, decay):
        """optax.trace: t = u + decay * t; the update is t."""
        if decay is None:
            return u
        t = u + decay * slot["trace"] if "trace" in slot else u
        slot["trace"] = t
        return t

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count,
                "slots": {k: dict(v) for k, v in self.slots.items()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        self.slots = {k: dict(v) for k, v in state["slots"].items()}


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it: at b2 = 0.999 the
    difference keeps few bits, so a float64 value would differ from
    optax's by up to 1e-5 of the step."""
    return float(_F32(1) - _F32(decay) ** _F32(count))


def _squared_norm(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The global gradient's squared L2 norm. A parameter held as one
    slice a rank of a model group (its `model_group`, parallel/mesh.py)
    adds its slices' squares summed over that group."""
    split = {k: params[k].model_group for k in grads
             if getattr(params[k], "model_group", None) is not None}
    if not split:
        return sum(torch.sum(g * g) for g in grads.values())
    total = sum(torch.sum(g * g) for k, g in grads.items() if k not in split)
    group = next(iter(split.values()))
    return total + dist.all_reduce_sum(
        sum(torch.sum(grads[k] * grads[k]) for k in split), group=group)


class MultiSteps:
    """optax.MultiSteps: accumulate the running mean of k micro-batch
    gradients and apply `inner` to it every k-th call; params stay as they
    are in between, and the inner step count moves only on an update."""

    def __init__(self, inner: Optimizer, every_k: int):
        self.inner = inner
        self.every_k = int(every_k)
        self.mini_step = 0
        self.acc: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        n = self.mini_step
        self.acc = {k: (self.acc[k] + (g - self.acc[k]) / (n + 1)
                        if k in self.acc else g / (n + 1))
                    for k, g in grads.items()}
        if n == self.every_k - 1:
            self.inner.update(params, self.acc)
            self.acc = {}
        self.mini_step = (n + 1) % self.every_k

    def state_dict(self) -> Dict[str, Any]:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": dict(self.acc)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        self.acc = dict(state["acc"])


def make_optimizer(model: nn.Module, optimizer: str = "SGD", lr: float = 0.05,
                   weight_decay: float = 2e-5,
                   norm_weight_decay: Optional[float] = 0.0,
                   warmup_epochs: int = 5, warmup_decay: float = 0.01,
                   max_epochs: int = 100, steps_per_epoch: int = 1000,
                   gradient_clip_val: Optional[float] = None,
                   momentum: Optional[float] = 0.9,
                   lr_scheduler: Optional[Dict[str, Any]] = None,
                   frozen_stages: int = 0,
                   **_ignored: Dict[str, Any]) -> Optimizer:
    """The optimizer the JAX package's `make_optimizer` builds, for
    `model`'s parameters (the model only labels them). With
    `norm_weight_decay=None` and nothing frozen every parameter takes
    `weight_decay`, as in the JAX package."""
    lr_fn, momentum_fn = resolve_schedules(lr, max_epochs, steps_per_epoch,
                                           warmup_epochs, warmup_decay,
                                           lr_scheduler)
    frozen_stages = int(frozen_stages or 0)
    labels = param_labels(model, frozen_stages)
    if norm_weight_decay is None and frozen_stages <= 0:
        labels = {k: "main" for k in labels}
    norm_wd = weight_decay if norm_weight_decay is None else norm_weight_decay
    return Optimizer(optimizer, labels, {"main": weight_decay, "norm": norm_wd},
                     lr_fn, momentum_fn, momentum=momentum,
                     gradient_clip_val=gradient_clip_val)


def named_grads(params: Dict[str, torch.Tensor], grads) -> Dict[str, torch.Tensor]:
    """Pair `torch.autograd.grad`'s results with the parameters' names; a
    parameter the loss does not reach (a frozen stage) gets a zero
    gradient."""
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}
