"""The operator namespace `centernet_lightning`, shared by every kernel
that an exported program keeps as an operator (the peak stage, the two
bounded DCN engines).

`torch.export` traces a ctypes launch as nothing it can keep, so each
kernel is also an operator: its plain twin on the CPU, its launch on
CUDA, its output shapes on Meta (what tracing runs). A saved `.pt2`
finds the operators once `import centernet_lightning_torch` has run. A
namespace takes one `DEF` library per process, hence this module.
`torch.library.custom_op` would import torch's tracing stack (some 800
modules) at the first call, and the larger heap slowed the host-bound
tracking loop's garbage collection.
"""
from __future__ import annotations

import torch

__all__ = ["LIB", "traced"]

LIB = torch.library.Library("centernet_lightning", "DEF")


def traced(x: torch.Tensor) -> bool:
    """Whether `x` is being traced (a fake or functional tensor of
    `torch.export`, or a call under `torch.compile`): the wrappers then
    call their operator, and skip the dispatcher's hop in eager calls."""
    return type(x) is not torch.Tensor or torch.compiler.is_compiling()
