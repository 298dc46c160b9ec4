"""Training loop (port of train/trainer.py, detection training without
validation).

`Trainer.fit` drives the train step (train/state.py) over a loader of
CollateDetection batches ({image (N, H, W, 3) uint8 or float, boxes
(N, K, 4) xywh, labels (N, K), mask (N, K)}, numpy or tensors), with
gradient accumulation, an EMA of the weights, per-step loss and LR logging
(train/{head}_loss, train/lr, train/images_per_sec), a checkpoint at the
end of every epoch and resume from the newest one. COCO and MOT validation
are not ported yet: a `val_loader` raises.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

import torch

from .checkpoint import (latest_checkpoint, load_checkpoint, restore_partial,
                         save_checkpoint)
from .logging import MetricLogger
from .optim import MultiSteps, make_optimizer, schedule_from_config
from .state import TrainState, make_eval_step, make_train_step, to_device

__all__ = ["Trainer"]


class Trainer:
    """Arguments as in the JAX package's Trainer, plus `device` ("cuda"
    unless the caller says otherwise). `precision` "bf16" / "bfloat16" /
    16 runs the forward and backward in bf16 with f32 master weights.
    `val_check_interval` is checked as the JAX Trainer checks it (a batch
    count past the epoch raises), for when validation is ported."""

    def __init__(self, task, train_loader=None, val_loader=None,
                 max_epochs: int = 100,
                 optimizer_config: Optional[Dict[str, Any]] = None,
                 ckpt_dir: Optional[str] = None, log_dir: Optional[str] = None,
                 monitor: str = "val/mAP", monitor_mode: str = "max",
                 val_interval: int = 1,
                 val_check_interval: Optional[float] = None,
                 image_size=(512, 512), seed: int = 0, resume: bool = True,
                 log_every: int = 50, precision: Optional[str] = None,
                 finetune_from: Optional[str] = None,
                 logger_config: Optional[Dict[str, Any]] = None,
                 accumulate_grad_batches: int = 1, ema_decay: float = 0.0,
                 device="cuda"):
        if val_loader is not None:
            raise NotImplementedError(
                "validation (COCO / MOT metrics) is ported with eval/ "
                "(ROADMAP Queue 1 item 12)")
        self.task = task
        self.train_loader = train_loader
        self.max_epochs = max_epochs
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.monitor_mode = monitor_mode
        self.val_interval = val_interval
        self.image_size = tuple(image_size)
        task.image_size = self.image_size   # checkpoints record it
        self.resume = resume
        self.log_every = log_every
        self.device = torch.device(device)
        self.logger = MetricLogger(log_dir, backends=tuple(
            (logger_config or {}).get("backends", ("tensorboard",))))

        opt_cfg = dict(optimizer_config or task.optimizer_config or {})
        opt_cfg.pop("jit", None)
        # the frozen backbone stages must be frozen in the optimizer too,
        # or weight decay shrinks them
        opt_cfg.setdefault("frozen_stages", (task.backbone_config or {})
                           .get("frozen_stages", 0))
        steps_per_epoch = len(train_loader) if train_loader else 1
        self.val_check_steps = None
        if val_check_interval and train_loader is not None:
            if val_check_interval < 1.0:
                self.val_check_steps = max(
                    1, int(steps_per_epoch * float(val_check_interval)))
            elif val_check_interval > 1:
                if int(val_check_interval) > steps_per_epoch:
                    raise ValueError(
                        f"val_check_interval={int(val_check_interval)} exceeds "
                        f"the {steps_per_epoch} batches in an epoch; "
                        f"validation would never run")
                self.val_check_steps = int(val_check_interval)
        self.accumulate = max(1, int(accumulate_grad_batches))
        if self.accumulate > 1:
            # the schedule counts optimizer updates
            steps_per_epoch = max(1, steps_per_epoch // self.accumulate)

        task.init(torch.Generator().manual_seed(seed))
        model = task.model.to(self.device, memory_format=torch.channels_last)
        if finetune_from:
            model.load_state_dict(restore_partial(finetune_from,
                                                  model.state_dict()))
        tx = make_optimizer(model, max_epochs=max_epochs,
                            steps_per_epoch=steps_per_epoch, **opt_cfg)
        # step -> lr for logging; it counts optimizer updates
        self.lr_schedule = schedule_from_config(opt_cfg, max_epochs,
                                                steps_per_epoch)
        if self.accumulate > 1:
            tx = MultiSteps(tx, self.accumulate)
        self.ema_decay = float(ema_decay)
        self.state = TrainState(model=model, tx=tx)
        if self.ema_decay > 0:
            self.state.init_ema()
        self.start_epoch = 0
        self.best_metric = -math.inf if monitor_mode == "max" else math.inf
        self._maybe_resume()

        compute_dtype = ("bfloat16" if str(precision) in ("16", "bf16", "bfloat16")
                         else None)
        self.train_step = make_train_step(task, compute_dtype=compute_dtype,
                                          ema_decay=self.ema_decay,
                                          ema_every=self.accumulate)
        self.eval_step = make_eval_step(task)
        self.last_losses: Optional[Dict[str, torch.Tensor]] = None

    def _maybe_resume(self) -> None:
        if not (self.resume and self.ckpt_dir):
            return
        latest = latest_checkpoint(self.ckpt_dir)
        if latest is None:
            return
        restored, _ = load_checkpoint(latest, map_location=self.device)
        self.state.model.load_state_dict(restored["model"])
        self.state.tx.load_state_dict(restored["opt_state"])
        self.state.step = int(restored["step"])
        if self.state.ema_params is not None:
            # a checkpoint from a run without EMA seeds it from the weights
            self.state.ema_params = restored.get("ema_params") or {
                k: p.detach().clone()
                for k, p in self.state.model.named_parameters()}
        self.start_epoch = int(restored.get("epoch", 0))
        self.best_metric = float(restored.get("best_metric", self.best_metric))
        print(f"resumed from {latest} (epoch {self.start_epoch})")

    def _save(self, epoch: int) -> None:
        if not self.ckpt_dir:
            return
        tree = {"model": self.state.model.state_dict(),
                "opt_state": self.state.tx.state_dict(),
                "step": self.state.step, "epoch": epoch,
                "best_metric": float(self.best_metric)}
        if self.state.ema_params is not None:
            tree["ema_params"] = self.state.ema_params
        save_checkpoint(self.ckpt_dir, tree, hparams=self.task.hparams,
                        step=self.state.step)

    def fit(self) -> TrainState:
        n_params = sum(p.numel() for p in self.state.model.parameters())
        print(f"parameters: {n_params / 1e6:.2f} M")
        try:
            return self._fit_loop()
        finally:
            self.logger.close()

    def _fit_loop(self) -> TrainState:
        step = self.state.step
        for epoch in range(self.start_epoch, self.max_epochs):
            t0 = time.time()
            n_imgs = 0
            for batch in self.train_loader:
                n_imgs += batch["image"].shape[0]
                self.state, losses = self.train_step(
                    self.state, to_device(batch, self.device))
                self.last_losses = losses
                step += 1
                if step % self.log_every == 0:
                    metrics = {f"train/{k}_loss": float(v)
                               for k, v in losses.items()}
                    metrics["train/images_per_sec"] = n_imgs / (time.time() - t0)
                    metrics["train/lr"] = float(
                        self.lr_schedule(step // self.accumulate))
                    self.logger.log(metrics, step)
            self._save(epoch + 1)
        return self.state
