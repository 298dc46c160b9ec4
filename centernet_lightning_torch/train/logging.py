"""Metric logging (port of train/logging.py): JSONL always; TensorBoard
(`torch.utils.tensorboard`) and/or Weights & Biases as config-selected
backends. Metric names are the JAX package's (train/{head}_loss, train/lr,
val/mAP, ...), so dashboards of the two packages line up. Images,
histograms and box overlays carry the Trainer's diagnostics.

A backend that cannot be imported is skipped with a warning; the JSONL
file and the other backends keep logging. W&B runs offline unless
`WANDB_MODE` says otherwise.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["MetricLogger"]


class MetricLogger:
    """Writes `log_dir/metrics.jsonl` and, per `backends` ("tensorboard",
    "wandb"), TensorBoard events in `log_dir` and a W&B run (`project`,
    `run_name`, `config`); with no `log_dir` it logs nothing."""

    def __init__(self, log_dir: Optional[str] = None,
                 backends: Sequence[str] = ("tensorboard",),
                 project: Optional[str] = None,
                 run_name: Optional[str] = None,
                 config: Optional[Dict] = None):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        self._wandb = None
        if not log_dir:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if "tensorboard" in backends:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as exc:
                warnings.warn(f"TensorBoard unavailable ({exc}); logging to "
                              "JSONL only")
            else:
                self._tb = SummaryWriter(log_dir)
        if "wandb" in backends:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=project or "centernet-lightning-tpu",
                    name=run_name, dir=log_dir, config=config,
                    mode=os.environ.get("WANDB_MODE", "offline"),
                )
            except Exception as exc:
                warnings.warn(f"wandb backend unavailable ({exc}); "
                              "falling back to TB/JSONL only")
                self._wandb = None

    def _write(self, step: int, values: Dict[str, float]) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "time": time.time(),
                                          **values}) + "\n")
            self._jsonl.flush()

    def log(self, metrics: Dict[str, float], step: int) -> None:
        metrics = {k: float(v) for k, v in metrics.items()}
        self._write(step, metrics)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_image(self, tag: str, image, step: int) -> None:
        """An HWC uint8 image (the diagnostics' grids)."""
        image = np.asarray(image)
        if self._tb is not None:
            self._tb.add_image(tag, image, step, dataformats="HWC")
            self._tb.flush()
        if self._wandb is not None:
            import wandb

            self._wandb.log({tag: wandb.Image(image)}, step=step)

    def log_histogram(self, tag: str, values, step: int) -> None:
        """A value distribution; the JSONL row holds its 5th, 50th and 95th
        percentiles (`<tag>/p5`, `/p50`, `/p95`)."""
        values = np.asarray(values, np.float64).reshape(-1)
        if values.size == 0:
            return
        q = np.percentile(values, [5, 50, 95])
        self._write(step, {f"{tag}/p5": float(q[0]), f"{tag}/p50": float(q[1]),
                           f"{tag}/p95": float(q[2])})
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)
            self._tb.flush()
        if self._wandb is not None:
            import wandb

            self._wandb.log({tag: wandb.Histogram(values)}, step=step)

    def log_boxes(self, tag: str, image, boxes, labels=None, scores=None,
                  step: int = 0, class_names=None) -> None:
        """A prediction overlay of xyxy pixel boxes: W&B gets its native box
        schema, TensorBoard the boxes drawn into the image."""
        from ..utils.viz import convert_bboxes_to_wandb, draw_boxes

        image = np.asarray(image)
        if self._wandb is not None:
            import wandb

            overlay = convert_bboxes_to_wandb(
                boxes, labels=labels, scores=scores, class_names=class_names,
                normalized_boxes=False,
            )
            self._wandb.log(
                {tag: wandb.Image(image, boxes={"predictions": overlay})},
                step=step,
            )
        if self._tb is not None:
            drawn = draw_boxes(image, np.asarray(boxes), labels=labels,
                               scores=scores)
            self.log_image(tag, drawn, step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
