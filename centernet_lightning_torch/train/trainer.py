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
scores.

Also as in the JAX package: a parameter-count report at `fit`'s start;
image diagnostics (the first train batch's target heatmaps, and on the
first validation batch the predictions, the score histogram and the
backbone's channel means), best-effort, one warning a run when they fail;
an optional torch.profiler trace of the first epoch under
`ckpt_dir/profile`; and a graceful stop on SIGTERM or SIGINT (finish the
step, checkpoint, return).

Over several processes (one a device, `parallel/dist.py`) the step is the
global batch's (the loaders' batch times the processes): rank 0's weights
are broadcast after init, resume and `finetune_from`; only rank 0 logs,
checkpoints, draws diagnostics and profiles (the others wait at a barrier
after a save); the processes agree on a stop every 10 steps; detection
validation splits the batches in contiguous blocks and unions the
predictions and targets, tracking validation gives each process whole
sequences (`sequence_id % processes`) and unions the per-sequence
results, so every process scores what one process would.
"""
from __future__ import annotations

import math
import os
import signal
import time
import warnings
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..eval.coco_eval import CocoEvaluator
from ..eval.mot import evaluate_mot_tracking_sequences
from ..models.meta import param_count_report
from ..models.tracker import Tracker
from ..parallel import dist
from ..utils import transfer
from ..utils.box_np import convert_box_format
from .checkpoint import (latest_checkpoint, load_checkpoint, restore_partial,
                         save_checkpoint)
from .logging import MetricLogger
from .optim import MultiSteps, make_optimizer, schedule_from_config
from .state import (TrainState, _mean_std, make_eval_step, make_train_step,
                    to_device)

__all__ = ["Trainer", "allgather_tracking_results"]

# the validation merge's schemas (key -> (trailing shape, dtype)), the JAX
# Trainer's
PRED_SCHEMA = {"boxes": ((4,), np.float64), "scores": ((), np.float64),
               "labels": ((), np.int64)}
TARGET_SCHEMA = {"boxes": ((4,), np.float64), "labels": ((), np.int64),
                 "iscrowd": ((), np.int64), "area": ((), np.float64)}


class Trainer:
    """Arguments as in the JAX package's Trainer, plus `device` ("cuda"
    unless the caller says otherwise). `precision` "bf16" / "bfloat16" /
    16 runs the forward and backward in bf16 with f32 master weights; the
    eval step runs in f32, as in the JAX package. `val_check_interval`: a
    float < 1 validates every that fraction of an epoch, an int > 1 every
    that many batches (more than an epoch's raises), 1 or None at the end
    of the epoch; `val_interval` picks the epochs that validate at all.
    `tracker_config` goes to the validation's `Tracker`. `diagnostics`
    logs the image diagnostics; `profile` traces the first epoch."""

    def __init__(self, task, train_loader=None, val_loader=None,
                 max_epochs: int = 100,
                 optimizer_config: Optional[Dict[str, Any]] = None,
                 ckpt_dir: Optional[str] = None, log_dir: Optional[str] = None,
                 monitor: str = "val/mAP", monitor_mode: str = "max",
                 val_interval: int = 1,
                 val_check_interval: Optional[float] = None,
                 image_size=(512, 512), seed: int = 0, resume: bool = True,
                 profile: bool = False, log_every: int = 50,
                 precision: Optional[str] = None,
                 finetune_from: Optional[str] = None,
                 logger_config: Optional[Dict[str, Any]] = None,
                 accumulate_grad_batches: int = 1, ema_decay: float = 0.0,
                 tracker_config: Optional[Dict[str, Any]] = None,
                 diagnostics: bool = True, device="cuda"):
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
        self.profile = profile
        self.log_every = log_every
        self.diagnostics = diagnostics
        self.device = torch.device(device)
        self.rank, self.world = dist.process_index(), dist.process_count()
        lc = dict(logger_config or {})
        if self.rank == 0:
            self.logger = MetricLogger(
                log_dir, backends=tuple(lc.get("backends", ("tensorboard",))),
                project=lc.get("project"), run_name=lc.get("run_name"),
                config=task.hparams)
        else:  # one writer a job
            self.logger = MetricLogger(None, backends=())

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
        # every process starts from rank 0's weights (each resumed from the
        # same checkpoint, so the optimizer's state agrees already)
        dist.broadcast_module(model)

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
        self._profiler = None
        self._diag_warned = False  # the first diagnostic failure warns
        self._stop_requested = False

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
        if self.rank == 0:
            print(f"resumed from {latest} (epoch {self.start_epoch})")

    def _save(self, epoch: int, tag: Optional[str] = None) -> None:
        """A checkpoint of the state after `epoch` epochs: untagged into
        `ckpt_dir` (the newest 3 kept), tagged into `ckpt_dir/<tag>` (the
        newest 1 kept), as the best checkpoint is. Rank 0 writes; every
        process returns once it is written."""
        if not self.ckpt_dir:
            return
        if self.rank != 0:
            dist.barrier()
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
        dist.barrier()

    # ------------------------------------------------------------------

    def _install_preemption_handler(self) -> Dict[int, Any]:
        """SIGTERM and SIGINT request a graceful stop: finish the current
        step, checkpoint, return, so that resuming continues the run. A
        second signal restores the old handler and raises the signal again,
        so a repeated Ctrl-C aborts. Off the main thread nothing is
        installed. Returns the handlers to restore."""
        self._stop_requested = False
        previous = {}

        def handler(signum, frame):
            if self._stop_requested:
                signal.signal(signum, previous.get(signum, signal.SIG_DFL))
                os.kill(os.getpid(), signum)
                return
            self._stop_requested = True
            if self.rank == 0:
                print(f"signal {signum}: stopping after the current step "
                      f"(checkpoint + clean exit); repeat to force-abort")

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass
        return previous

    _STOP_SYNC_EVERY = 10

    def _should_stop(self, step: int) -> bool:
        """Whether to stop after `step`. One process: whether a stop was
        requested. Several: the signal may reach some processes only, or
        at different steps, and a process that stopped alone would leave
        the others waiting in the next step's collectives; so the flags
        are gathered every `_STOP_SYNC_EVERY` steps (not every step, which
        would add a host round trip to each) and all stop at the same
        step when any asked."""
        if self.world == 1:
            return self._stop_requested
        if step % self._STOP_SYNC_EVERY != 0:
            return False
        flags = dist.all_gather_host(
            np.asarray([1.0 if self._stop_requested else 0.0]))
        self._stop_requested = bool(np.asarray(flags).any())
        return self._stop_requested

    @staticmethod
    def _restore_signal_handlers(previous: Dict[int, Any]) -> None:
        for sig, h in previous.items():
            signal.signal(sig, h)

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self) -> None:
        """Close the trace if one is open (the first epoch's end, a
        preemption stop, or an error) and write it to
        `ckpt_dir/profile/trace_step_<step>.json` (Chrome trace format)."""
        if self._profiler is not None:
            prof, self._profiler = self._profiler, None
            prof.stop()
            out = os.path.join(self.ckpt_dir or ".", "profile")
            os.makedirs(out, exist_ok=True)
            path = os.path.join(out, f"trace_step_{self.state.step}.json")
            prof.export_chrome_trace(path)
            print(f"profile trace written to {path}")
        self.profile = False

    def fit(self) -> TrainState:
        if self.rank == 0:
            print(param_count_report(self.state.model))
        if self.profile and self.rank == 0:
            self._start_profile()
        previous_handlers = self._install_preemption_handler()
        try:
            return self._fit_loop()
        finally:
            self._restore_signal_handlers(previous_handlers)
            self._stop_profile()
            self.logger.close()

    def _fit_loop(self) -> TrainState:
        first_batch_logged = not self.diagnostics or self.rank != 0
        step = self.state.step
        for epoch in range(self.start_epoch, self.max_epochs):
            t0 = time.time()
            n_imgs = 0
            for batch_idx, batch in enumerate(self.train_loader):
                if not first_batch_logged:
                    self._log_heatmap_diagnostic(batch)
                    first_batch_logged = True
                n_imgs += batch["image"].shape[0]
                self.state, losses = self.train_step(
                    self.state, to_device(batch, self.device))
                self.last_losses = losses
                step += 1
                if self._should_stop(step):
                    self._stop_profile()
                    self._save(epoch)  # resuming restarts this epoch
                    if self.rank == 0:
                        print(f"preempted at step {step}: checkpoint "
                              f"written, exiting cleanly")
                    return self.state
                if step % self.log_every == 0:
                    metrics = {f"train/{k}_loss": float(v)
                               for k, v in losses.items()}
                    metrics["train/images_per_sec"] = (
                        n_imgs * self.world / (time.time() - t0))
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
            if epoch == self.start_epoch:
                self._stop_profile()
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

    # ---- diagnostics ------------------------------------------------------

    def _warn_diagnostic_failure(self, which: str, exc: Exception) -> None:
        """Diagnostics must not break training, nor fail unseen: the first
        failure of a run warns, later ones stay quiet."""
        if self._diag_warned:
            return
        self._diag_warned = True
        warnings.warn(
            f"diagnostic logging ({which}) failed and will be skipped for "
            f"this run: {type(exc).__name__}: {exc}",
            RuntimeWarning, stacklevel=3)

    def _log_heatmap_diagnostic(self, batch) -> None:
        """The target heatmaps of the first 4 images of the first train
        batch, overlaid on them in one grid (diagnostics/target_heatmap)."""
        try:
            from ..ops.targets import render_heatmap
            from ..utils.viz import render_heatmap_diagnostic

            part = {k: torch.as_tensor(batch[k][:4]).cpu()
                    for k in ("image", "boxes", "labels", "mask")}
            img = part["image"].numpy()
            h, w = img.shape[1:3]
            stride = self.task.stride
            hm = render_heatmap(
                part["boxes"].float(), part["labels"].int(), part["mask"],
                self.task.num_classes, h // stride, w // stride, stride,
                self.task._radius_fn).numpy()
            grid = render_heatmap_diagnostic(img, hm)
            self.logger.log_image("diagnostics/target_heatmap", grid, 0)
        except Exception as exc:
            self._warn_diagnostic_failure("target_heatmap", exc)

    def _log_prediction_diagnostic(self, batch, dets, step: int) -> None:
        """On the first validation batch: its first 4 images with their
        detections scored 0.3 or more (diagnostics/val_predictions), the
        scores' histogram (diagnostics/det_scores), the first image's box
        overlay (diagnostics/val_boxes) and the backbone's channel means."""
        try:
            from ..utils.viz import draw_boxes, make_image_grid

            tiles = []
            for i in range(min(4, batch["image"].shape[0])):
                keep = dets["scores"][i] >= 0.3
                tiles.append(draw_boxes(
                    np.asarray(batch["image"][i]),
                    np.asarray(dets["boxes"][i])[keep],
                    labels=np.asarray(dets["labels"][i])[keep],
                    scores=np.asarray(dets["scores"][i])[keep],
                ))
            self.logger.log_image("diagnostics/val_predictions",
                                  make_image_grid(tiles, ncols=2), step)
            self.logger.log_histogram("diagnostics/det_scores",
                                      dets["scores"], step)
            self.logger.log_boxes(
                "diagnostics/val_boxes", np.asarray(batch["image"][0]),
                np.asarray(dets["boxes"][0]),
                labels=np.asarray(dets["labels"][0]),
                scores=np.asarray(dets["scores"][0]), step=step,
            )
            self._log_feature_diagnostic(batch, step)
        except Exception as exc:
            self._warn_diagnostic_failure("val_predictions", exc)

    @torch.no_grad()
    def _backbone_channel_means(self, images) -> list:
        """The channel mean of each backbone pyramid level of `images`
        (NHWC, uint8 normalised as the train step does), one eval-mode pass
        of `model.backbone` on the model's own weights: (N, H_l, W_l)
        numpy maps, finest first."""
        model = self.state.model
        was_training = model.training
        model.eval()
        try:
            x = transfer.upload(images, self.device)
            if x.dtype == torch.uint8:
                from ..ops.preprocess import preprocess

                mean, std = _mean_std(self.task)
                x = preprocess(x, mean=mean, std=std)
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            return [level.float().mean(dim=1).cpu().numpy()
                    for level in model.backbone(x)]
        finally:
            model.train(was_training)

    def _log_feature_diagnostic(self, batch, step: int) -> None:
        """The backbone's channel means on the first validation image,
        viridis-mapped, scaled to the finest level's size and tiled
        (diagnostics/backbone_features)."""
        import cv2

        from ..utils.viz import apply_mpl_cmap, make_image_grid

        levels = self._backbone_channel_means(batch["image"][:1])
        size = max(level.shape[1] for level in levels)
        tiles = [cv2.resize(apply_mpl_cmap(level[0]), (size, size),
                            interpolation=cv2.INTER_NEAREST)
                 for level in levels]
        self.logger.log_image("diagnostics/backbone_features",
                              make_image_grid(tiles, ncols=2), step)

    def _eval_batches(self, keep: Optional[Callable[[int, Dict[str, Any]],
                                                    bool]] = None
                      ) -> Iterator[Tuple[Dict[str, Any],
                                          Dict[str, np.ndarray]]]:
        """(batch, detections as numpy arrays) for each validation batch
        (each that `keep(index, batch)` accepts), one batch deep: the next
        batch's images go up (pinned) and its forward and decode are
        queued before the host waits, on an event, for this batch's copies
        to the host. Fills `val_stats`."""
        stats = {"batches": 0, "images": 0, "seconds": 0.0, "wait_s": 0.0}
        self.val_stats = stats
        t0 = time.perf_counter()

        def dispatched():
            for i, batch in enumerate(self.val_loader):
                if keep is not None and not keep(i, batch):
                    continue
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
        them.

        Over several processes each takes a contiguous block of the
        loader's batches, and the predictions and targets are unioned in
        rank order (`gather_object_lists`), which is the loader's order:
        every process scores the whole set as one process would."""
        evaluator = CocoEvaluator(self.task.num_classes)
        logged = not self.diagnostics or self.rank != 0
        keep = None
        if self.world > 1:
            n_batches = len(self.val_loader)
            lo = self.rank * n_batches // self.world
            hi = (self.rank + 1) * n_batches // self.world
            keep = lambda i, _batch: lo <= i < hi  # noqa: E731
        for batch, dets in self._eval_batches(keep):
            if not logged:
                self._log_prediction_diagnostic(batch, dets, self.state.step)
                logged = True
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
        if self.world > 1:
            # the schemas shape the collective, so they are the same on
            # every process: iscrowd defaults to 0 and area to the box's
            # w * h (the evaluator's own fallback) where a set has none
            for t in evaluator.targets:
                t.setdefault("iscrowd", np.zeros(len(t["labels"]), np.int64))
                t.setdefault("area", (np.asarray(t["boxes"])[:, 2]
                                      * np.asarray(t["boxes"])[:, 3]))
            evaluator.preds = dist.gather_object_lists(evaluator.preds,
                                                       PRED_SCHEMA)
            evaluator.targets = dist.gather_object_lists(evaluator.targets,
                                                         TARGET_SCHEMA)
        return {f"val/{k}": v for k, v in evaluator.get_metrics().items()}

    def validate_tracking(self) -> Dict[str, float]:
        """MOT validation with one tracker a sequence: the tracker is reset
        where `sequence_id` changes (a batch without it is sequence 0), and
        the metrics of the sequences are combined as TrackEval combines
        them (eval/mot.py). Boxes are scaled to the input's size; only
        active tracks are reported. Per-sequence keys (val/seq<id>/...)
        only when there are several sequences.

        Over several processes association runs a sequence at a time, so
        whole sequences are dealt out (`sequence_id % processes`): every
        process reads the whole set, forwards and tracks only batches that
        hold its own sequences, and the per-sequence results are unioned,
        so every process scores what one process would."""
        tracker = Tracker(model=None, **self.tracker_config)
        per_seq: Dict[int, Dict[str, list]] = {}
        current_seq = None
        logged = not self.diagnostics or self.rank != 0

        def seq_ids_of(batch):
            n = batch["image"].shape[0]
            return np.asarray(batch.get("sequence_id", np.zeros(n, np.int64)))

        keep = None
        if self.world > 1:
            keep = lambda _i, batch: bool(  # noqa: E731
                ((seq_ids_of(batch) % self.world) == self.rank).any())
        for batch, dets in self._eval_batches(keep):
            if not logged:
                self._log_prediction_diagnostic(batch, dets, self.state.step)
                logged = True
            n = batch["image"].shape[0]
            seq_ids = seq_ids_of(batch)
            in_h, in_w = batch["image"].shape[1:3]
            scale = np.array([in_w, in_h, in_w, in_h])
            mask = np.asarray(batch["mask"]).astype(bool)
            gt_boxes, gt_ids = np.asarray(batch["boxes"]), np.asarray(batch["ids"])
            for i in range(n):
                sid = int(seq_ids[i])
                if sid % self.world != self.rank:
                    continue
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
        if self.world > 1:
            per_seq = allgather_tracking_results(per_seq)
        metrics = evaluate_mot_tracking_sequences(
            {f"seq{k}": v for k, v in sorted(per_seq.items())})
        if len(per_seq) <= 1:
            metrics = {k: v for k, v in metrics.items() if "/" not in k}
        return {f"val/{k}": v for k, v in metrics.items()}


def allgather_tracking_results(per_seq: Dict[int, Dict[str, list]],
                               _allgather=None,
                               _process_count: Optional[int] = None,
                               ) -> Dict[int, Dict[str, list]]:
    """Union the processes' tracking results (sequence -> per-frame ragged
    box and id lists) through `gather_object_lists`. The processes hold
    disjoint sequences; frames are keyed explicitly so that empty frames
    survive. `_allgather` / `_process_count` can be injected for tests."""

    def flatten(entry, box_key, id_key, sid):
        boxes, ids, frames = [], [], []
        for j, (bxs, tids) in enumerate(zip(entry[box_key], entry[id_key])):
            b = np.asarray(bxs, np.float64).reshape(-1, 4)
            boxes.append(b)
            ids.append(np.asarray(tids, np.int64).reshape(-1))
            frames.append(np.full(len(b), j, np.int64))
        b = np.concatenate(boxes) if boxes else np.zeros((0, 4), np.float64)
        i = np.concatenate(ids) if ids else np.zeros((0,), np.int64)
        f = np.concatenate(frames) if frames else np.zeros((0,), np.int64)
        return {"boxes": b, "ids": i, "frame": f,
                "seq": np.full(len(b), sid, np.int64)}

    meta_items, pred_items, tgt_items = [], [], []
    for sid, entry in sorted(per_seq.items()):
        meta_items.append(
            {"info": np.asarray([[sid, len(entry["pred_bboxes"])]], np.int64)})
        pred_items.append(flatten(entry, "pred_bboxes", "pred_track_ids", sid))
        tgt_items.append(
            flatten(entry, "target_bboxes", "target_track_ids", sid))

    kw = {"_allgather": _allgather, "_process_count": _process_count}
    meta = dist.gather_object_lists(meta_items, {"info": ((2,), np.int64)},
                                    **kw)
    schema = {"boxes": ((4,), np.float64), "ids": ((), np.int64),
              "frame": ((), np.int64), "seq": ((), np.int64)}
    preds = dist.gather_object_lists(pred_items, schema, **kw)
    tgts = dist.gather_object_lists(tgt_items, schema, **kw)

    out: Dict[int, Dict[str, list]] = {}
    for m in meta:
        sid, nf = int(m["info"][0, 0]), int(m["info"][0, 1])
        out[sid] = {
            "pred_bboxes": [np.zeros((0, 4)) for _ in range(nf)],
            "pred_track_ids": [np.zeros((0,), np.int64) for _ in range(nf)],
            "target_bboxes": [np.zeros((0, 4)) for _ in range(nf)],
            "target_track_ids": [np.zeros((0,), np.int64)
                                 for _ in range(nf)],
        }
    for items, box_key, id_key in ((preds, "pred_bboxes", "pred_track_ids"),
                                   (tgts, "target_bboxes",
                                    "target_track_ids")):
        for it in items:
            if not len(it["seq"]):
                continue
            entry = out[int(it["seq"][0])]
            for j in np.unique(it["frame"]):
                sel = it["frame"] == j
                entry[box_key][int(j)] = it["boxes"][sel]
                entry[id_key][int(j)] = it["ids"][sel]
    return out
