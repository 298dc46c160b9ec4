"""Train state and the train / eval steps (port of train/state.py).

The JAX step is one pure jitted function of the state. Here the state owns
the model (f32 master parameters and BatchNorm buffers), the optimizer and
the EMA, and a step updates them in place, which saves a copy of every
tensor; `step_fn(state, batch)` still returns `(state, losses)`.

A step: uint8 images normalised on the device; the forward in
`compute_dtype` (bf16: the parameters are cast, so the gradients come back
f32 through the cast, and BatchNorm keeps f32 running statistics); the
losses in f32 (the task's `train_forward` when it has one, as FairMOT
does, else its `compute_loss` on the forward); the gradient; the optimizer
update; the EMA. While a profiler runs the step is the span `train.step`
(utils/spans.py) around `train.cast`, `train.forward`, `train.loss` (none
for `train_forward`, whose span `train.forward` holds the losses),
`train.backward` and `train.optimizer`.

Over several processes (`parallel/dist.py`) each takes the step on its
slice of the global batch: BatchNorm's statistics and the losses' counts
are the global batch's, the optimizer averages the gradients over the
processes before it clips, and the losses returned are the global ones.
The model is not wrapped in DistributedDataParallel, whose hooks would
not see the gradients of the bf16 `functional_call` copies. On a
(data, model) grid (`make_train_step(mesh=...)`, parallel/mesh.py) the
step's collectives run over the data group: each rank takes its data
rank's rows, and the ranks of a model group, with the same rows, stay
equal (their column-parallel convolutions hold slices of the weights).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, preprocess
from ..parallel import dist
from ..utils.spans import span
from .optim import named_grads

__all__ = ["TrainState", "make_train_step", "make_eval_step", "to_device"]

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "float32": torch.float32}


@dataclass
class TrainState:
    """model: the task's model (parameters + BatchNorm statistics), on the
    device, f32; tx: `optim.Optimizer` or `optim.MultiSteps`; step: micro
    steps taken; ema_params: name -> f32 tensor, or None for no EMA."""
    model: nn.Module
    tx: Any
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def init_ema(self) -> None:
        self.ema_params = {k: p.detach().clone()
                           for k, p in self.model.named_parameters()}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on `device` (ids and other
    non-array entries dropped)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


class _Method(nn.Module):
    """`model.<name>` as a module's forward, so `functional_call` can run
    any method of the model with substituted parameters."""

    def __init__(self, model: nn.Module, name: str):
        super().__init__()
        self.model = model
        self.name = name

    def forward(self, *args):
        return getattr(self.model, self.name)(*args)


def _caller(model: nn.Module, params: Optional[Dict[str, torch.Tensor]]):
    """call(name, *args): the model's method `name` on `args`, with
    `params` (name -> tensor) in place of its parameters when given."""
    if params is None:
        return lambda name, *args: getattr(model, name)(*args)
    scoped = {f"model.{k}": v for k, v in params.items()}
    return lambda name, *args: functional_call(_Method(model, name), scoped,
                                               args)


def _mean_std(task):
    return (getattr(task, "image_mean", None) or IMAGENET_MEAN,
            getattr(task, "image_std", None) or IMAGENET_STD)


def make_train_step(task, compute_dtype: Optional[Any] = None,
                    ema_decay: float = 0.0, ema_every: int = 1,
                    mesh=None) -> Callable:
    """step_fn(state, batch) -> (state, losses): one training step.

    batch: {image (N, H, W, 3) uint8 or float, boxes, labels, mask, and
    ids for FairMOT}, on the model's device. compute_dtype "bfloat16" runs
    the forward and backward in bf16 with f32 master weights (no autocast:
    every op, BatchNorm included, sees bf16, as in the JAX step). ema_decay > 0 keeps
    `state.ema_params` with the decay min(ema_decay, (1+t)/(10+t)), t the
    number of optimizer updates; under accumulation (ema_every = k) it
    moves on every k-th step only. Losses come back as f32 scalars, still
    on the device. `mesh` (parallel/mesh.py) takes the step on a
    (data, model) grid: batch is the data rank's rows.
    """
    data_group = mesh.data_group if mesh is not None else None
    dtype = _DTYPES[str(compute_dtype)] if compute_dtype else None
    mean, std = _mean_std(task)

    def prepare(images: torch.Tensor) -> torch.Tensor:
        if images.dtype == torch.uint8:
            return preprocess(images, mean=mean, std=std,
                              dtype=dtype or torch.float32)
        return images.to(dtype) if dtype is not None else images

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with dist.data_parallel(data_group):
            return step(state, batch)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with span("train.step"):
            model = state.model.train()
            params = state.params()
            with span("train.cast"):
                cast = (None if dtype is None else
                        {k: p.to(dtype) for k, p in params.items()})
            call = _caller(model, cast)
            fwd_batch = dict(batch, image=prepare(batch["image"]))
            train_forward = getattr(task, "train_forward", None)
            if train_forward is not None:
                with span("train.forward"):
                    losses = train_forward(call, fwd_batch)
            else:
                with span("train.forward"):
                    outputs = call("forward", fwd_batch["image"])
                with span("train.loss"):
                    losses = task.compute_loss(outputs, fwd_batch)
            with span("train.backward"):
                grads = torch.autograd.grad(losses["total"], list(params.values()),
                                            allow_unused=True)
            with span("train.optimizer"):
                state.tx.update(params, named_grads(params, grads))
            state.step += 1
            if ema_decay > 0 and state.ema_params is not None \
                    and state.step % ema_every == 0:
                t = np.float32(state.step // ema_every)
                d = float(np.minimum(np.float32(ema_decay),
                                     (np.float32(1) + t) / (np.float32(10) + t)))
                with torch.no_grad():
                    for k, e in state.ema_params.items():
                        e.copy_(e * d + params[k] * (1.0 - d))
            return state, dist.mean_losses({k: v.detach()
                                            for k, v in losses.items()})

    return train_step


def make_eval_step(task, num_detections: Optional[int] = None) -> Callable:
    """eval_step(state, batch) -> detections: f32 forward in eval mode on
    the EMA weights when the state has them, then the decode from logits
    (on the card, through the peak kernel)."""
    mean, std = _mean_std(task)

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model.eval()
        images = batch["image"]
        if images.dtype == torch.uint8:
            images = preprocess(images, mean=mean, std=std)
        outputs = (model(images) if state.ema_params is None
                   else functional_call(model, state.ema_params, (images,)))
        return task.decode_detections(
            outputs["heatmap"], outputs["box_2d"], reid=outputs.get("reid"),
            num_detections=num_detections, from_logits=True)

    return eval_step
