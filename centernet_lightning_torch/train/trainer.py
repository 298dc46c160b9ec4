"""Training loop with validation (port of train/trainer.py).

`Trainer.fit` drives the train step (train/state.py) over a loader of
CollateDetection batches ({image (N, H, W, 3) uint8 or float, boxes
(N, K, 4) xywh, labels (N, K), mask (N, K)}, numpy or tensors), with
gradient accumulation, an EMA of the weights, per-step loss and LR logging
(train/{head}_loss, train/lr, train/images_per_sec), a checkpoint at the
end of every epoch and resume from the newest one.

With a `val_loader` it validates every `val_interval` epochs, or every
`val_check_interval` of an epoch within those epochs, logs `val/*` and
keeps the best checkpoint on `monitor` under `ckpt_dir/best`. Detection
tasks are scored by the COCO protocol (`validate_detection`: val/mAP and
the 11 other COCO metrics), tracking tasks (a `reid_config`) by the MOT
metrics with one tracker a sequence (`validate_tracking`: val/MOTA,
val/IDF1, val/HOTA). Validation runs one batch deep: the next batch's
upload (pinned), forward and decode are queued before the host waits for
the previous batch's detections, so the card computes while the host
scores. Multi-process gathers (DDP) and the image diagnostics are not
ported (ROADMAP Queue 1 items 6 and 3).
"""
from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..eval.coco_eval import CocoEvaluator
from ..eval.mot import evaluate_mot_tracking_sequences
from ..models.tracker import Tracker
from ..utils import transfer
from ..utils.box_np import convert_box_format
from .checkpoint import (latest_checkpoint, load_checkpoint, restore_partial,
                         save_checkpoint)
from .logging import MetricLogger
from .optim import MultiSteps, make_optimizer, schedule_from_config
from .state import TrainState, make_eval_step, make_train_step, to_device

__all__ = ["Trainer"]


class Trainer:
    """Arguments as in the JAX package's Trainer, plus `device` ("cuda"
    unless the caller says otherwise). `precision` "bf16" / "bfloat16" /
    16 runs the forward and backward in bf16 with f32 master weights; the
    eval step runs in f32, as in the JAX package. `val_check_interval`: a
    float < 1 validates every that fraction of an epoch, an int > 1 every
    that many batches (more than an epoch's raises), 1 or None at the end
    of the epoch; `val_interval` picks the epochs that validate at all.
    `tracker_config` goes to the validation's `Tracker`. `diagnostics`
    (image logging) is not ported and must stay False, its default here
    (the JAX package's default is True)."""

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
                 tracker_config: Optional[Dict[str, Any]] = None,
                 diagnostics: bool = False, device="cuda"):
        if diagnostics:
            raise NotImplementedError(
                "the image diagnostics (utils/viz.py) are not ported yet "
                "(ROADMAP Queue 1 item 3); pass diagnostics=False")
        self.task = task
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.tracker_config = tracker_config or {}
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
        # the last validation's batch loop: batches, images, its wall
        # seconds and the seconds the host waited for the card's
        # detections (the metrics computed after the loop not included)
        self.val_stats: Dict[str, float] = {}

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

    def _save(self, epoch: int, tag: Optional[str] = None) -> None:
        """A checkpoint of the state after `epoch` epochs: untagged into
        `ckpt_dir` (the newest 3 kept), tagged into `ckpt_dir/<tag>` (the
        newest 1 kept), as the best checkpoint is."""
        if not self.ckpt_dir:
            return
        tree = {"model": self.state.model.state_dict(),
                "opt_state": self.state.tx.state_dict(),
                "step": self.state.step, "epoch": epoch,
                "best_metric": float(self.best_metric)}
        if self.state.ema_params is not None:
            tree["ema_params"] = self.state.ema_params
        ckpt_dir = os.path.join(self.ckpt_dir, tag) if tag else self.ckpt_dir
        save_checkpoint(ckpt_dir, tree, hparams=self.task.hparams,
                        step=self.state.step, keep_last=1 if tag else 3)

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
            for batch_idx, batch in enumerate(self.train_loader):
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
                if (self.val_check_steps and self.val_loader is not None
                        and (batch_idx + 1) % self.val_check_steps == 0
                        and (epoch + 1) % self.val_interval == 0):
                    # mid-epoch, on a batch counter of the epoch (its last
                    # hit is the epoch-end validation); val_interval picks
                    # the epochs that validate at all
                    self._run_validation(epoch + 1)
            if (self.val_loader is not None and self.val_check_steps is None
                    and (epoch + 1) % self.val_interval == 0):
                self._run_validation(epoch + 1)
            self._save(epoch + 1)
        return self.state

    def _run_validation(self, epoch: int) -> Dict[str, float]:
        """One validation pass, its metrics logged, and the best checkpoint
        saved when `monitor` improved."""
        metrics = self.validate()
        self.logger.log(metrics, self.state.step)
        score = metrics.get(self.monitor)
        if score is not None:
            better = (score > self.best_metric if self.monitor_mode == "max"
                      else score < self.best_metric)
            if better:
                self.best_metric = score
                self._save(epoch, tag="best")
        return metrics

    def validate(self) -> Dict[str, float]:
        if self.task.reid_config is not None:
            return self.validate_tracking()
        return self.validate_detection()

    def _eval_batches(self) -> Iterator[Tuple[Dict[str, Any],
                                              Dict[str, np.ndarray]]]:
        """(batch, detections as numpy arrays) for each validation batch,
        one batch deep: the next batch's images go up (pinned) and its
        forward and decode are queued before the host waits, on an event,
        for this batch's copies to the host. Fills `val_stats`."""
        stats = {"batches": 0, "images": 0, "seconds": 0.0, "wait_s": 0.0}
        self.val_stats = stats
        t0 = time.perf_counter()

        def dispatched():
            for batch in self.val_loader:
                images = transfer.upload(batch["image"], self.device)
                dets = self.eval_step(self.state, {"image": images})
                yield (batch, *transfer.host_copies(dets))

        it = dispatched()
        pending = next(it, None)
        while pending is not None:
            batch, host, event = pending
            pending = next(it, None)       # queue the next batch first
            if event is not None:
                t = time.perf_counter()
                event.synchronize()
                stats["wait_s"] += time.perf_counter() - t
            stats["batches"] += 1
            stats["images"] += batch["image"].shape[0]
            yield batch, {k: v.numpy() for k, v in host.items()}
        stats["seconds"] = time.perf_counter() - t0

    def validate_detection(self) -> Dict[str, float]:
        """COCO validation: the 12 COCO metrics as val/<name>. Boxes reach
        the evaluator as the decode's f32 xyxy converted to xywh; targets
        are masked per image, with `iscrowd` and `area` when the batch has
        them."""
        evaluator = CocoEvaluator(self.task.num_classes)
        for batch, dets in self._eval_batches():
            boxes_xywh = convert_box_format(dets["boxes"], "xyxy", "xywh")
            n = batch["image"].shape[0]
            preds = [{"boxes": boxes_xywh[i], "scores": dets["scores"][i],
                      "labels": dets["labels"][i]} for i in range(n)]
            mask = np.asarray(batch["mask"]).astype(bool)
            keys = [k for k in ("boxes", "labels", "iscrowd", "area")
                    if k in batch]
            targets = [{k: np.asarray(batch[k][i])[mask[i]] for k in keys}
                       for i in range(n)]
            evaluator.update(preds, targets)
        return {f"val/{k}": v for k, v in evaluator.get_metrics().items()}

    def validate_tracking(self) -> Dict[str, float]:
        """MOT validation with one tracker a sequence: the tracker is reset
        where `sequence_id` changes (a batch without it is sequence 0), and
        the metrics of the sequences are combined as TrackEval combines
        them (eval/mot.py). Boxes are scaled to the input's size; only
        active tracks are reported. Per-sequence keys (val/seq<id>/...)
        only when there are several sequences."""
        tracker = Tracker(model=None, **self.tracker_config)
        per_seq: Dict[int, Dict[str, list]] = {}
        current_seq = None
        for batch, dets in self._eval_batches():
            n = batch["image"].shape[0]
            seq_ids = np.asarray(batch.get("sequence_id", np.zeros(n, np.int64)))
            in_h, in_w = batch["image"].shape[1:3]
            scale = np.array([in_w, in_h, in_w, in_h])
            mask = np.asarray(batch["mask"]).astype(bool)
            gt_boxes, gt_ids = np.asarray(batch["boxes"]), np.asarray(batch["ids"])
            for i in range(n):
                sid = int(seq_ids[i])
                if sid != current_seq:
                    tracker.reset()
                    current_seq = sid
                entry = per_seq.setdefault(sid, {
                    "pred_bboxes": [], "pred_track_ids": [],
                    "target_bboxes": [], "target_track_ids": [],
                })
                tracker.update(dets["boxes"][i] / scale, dets["labels"][i],
                               dets["scores"][i], dets["embeddings"][i])
                live = [t for t in tracker.tracks if t.active]
                entry["pred_bboxes"].append(
                    [convert_box_format(t.bbox, "xyxy", "xywh") for t in live])
                entry["pred_track_ids"].append([t.track_id for t in live])
                entry["target_bboxes"].append(gt_boxes[i][mask[i]] / scale)
                entry["target_track_ids"].append(gt_ids[i][mask[i]])
        metrics = evaluate_mot_tracking_sequences(
            {f"seq{k}": v for k, v in sorted(per_seq.items())})
        if len(per_seq) <= 1:
            metrics = {k: v for k, v in metrics.items() if "/" not in k}
        return {f"val/{k}": v for k, v in metrics.items()}
