"""Metric logging (port of train/logging.py): JSONL always; TensorBoard when
`torch.utils.tensorboard` can be imported, skipped with a warning
otherwise. Metric names are the JAX package's (train/{head}_loss,
train/lr, ...)."""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, Optional, Sequence

__all__ = ["MetricLogger"]


class MetricLogger:
    """Writes `log_dir/metrics.jsonl` (and TensorBoard events); with no
    `log_dir` it logs nothing. `backends` may name "tensorboard"; other
    backends of the JAX package (wandb) are not ported and are skipped
    with a warning."""

    def __init__(self, log_dir: Optional[str] = None,
                 backends: Sequence[str] = ("tensorboard",)):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if not log_dir:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        for name in backends:
            if name != "tensorboard":
                warnings.warn(f"logging backend {name!r} is not ported; "
                              "logging to JSONL and TensorBoard only")
                continue
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as exc:
                warnings.warn(f"TensorBoard unavailable ({exc}); logging to "
                              "JSONL only")
                continue
            self._tb = SummaryWriter(log_dir)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "time": time.time(),
                                          **metrics}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
