"""The least time of the exact DCNv2 engine's sampling (the taps of every
deformable block, before the matrix product), whatever kernels implement
it: for each block, x read once, the 27 offset and mask channels read
once, and the (N, H, W, 9, C) taps written once, all in the model's
dtype; f32 arithmetic on the CUDA cores, per tap value 4 corners x
(multiply + add) and the mask's multiply, per pixel and tap about 10 for
the corner weights. The bytes bound it on an H100.

The blocks' shapes are the reference's (reference/necks/dlaup.py:
block_inputs), so a later engine is judged on the same work."""
from __future__ import annotations

import functools
import importlib
from typing import List, Tuple

import torch

from . import kernels, peaks

TAPS = kernels.TAPS
OFFSET_MASK = 3 * TAPS       # (dy, dx) a tap, then the mask


def sampling_bytes(c: int, h: int, w: int, elt: int) -> int:
    """Bytes one image's block of input (C, H, W) reads and writes."""
    return h * w * (c * elt + OFFSET_MASK * elt + TAPS * c * elt)


def sampling_ops(c: int, h: int, w: int) -> int:
    return h * w * TAPS * (9 * c + 10)


def least_s(blocks: List[Tuple[int, int, int]], images: int, elt: int) -> float:
    """Least time of the blocks' sampling over `images` images."""
    return sum(kernels.bound_s(images * sampling_bytes(c, h, w, elt),
                               images * sampling_ops(c, h, w), peaks.F32_OPS)
               for c, h, w in blocks)


@functools.lru_cache(maxsize=8)
def block_inputs(image_size: Tuple[int, int], backbone: str = "dla34",
                 neck: str = "dlaup") -> Tuple[Tuple[int, int, int], ...]:
    """(C, H, W) of each deformable block's input for one image, from the
    reference's backbone and neck on meta tensors."""
    from reference.nn import Ctx

    bb = importlib.import_module(f"reference.backbones.{backbone}")
    nk = importlib.import_module(f"reference.necks.{neck}")
    fns, outs = bb.stages()
    ctx = Ctx(spec={})
    x = torch.zeros((1, 3, *image_size), device="meta")
    feats = []
    for i, fn in enumerate(fns):
        x = fn(ctx, x)
        if i in outs:
            feats.append(x)
    return tuple(nk.block_inputs(feats))
