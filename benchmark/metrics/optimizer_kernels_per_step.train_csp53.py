"""Kernels launched inside the span `train.optimizer` (the per-tensor AdamW loop, train/optim.py), a training step of the csp53 cell."""
from cnbench.spans import span_kernels_per_step


def read(rec):
    return span_kernels_per_step(rec, ("train.optimizer",))
