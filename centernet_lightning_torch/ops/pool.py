"""3x3 / stride-2 / pad-1 max pool over NHWC maps: the CUDA kernel, its
plain twin and the dispatch (port of ops/pallas_pool.py).

As in the JAX package, nothing on the model's path calls it: the ResNet
stem keeps `F.max_pool2d` (the JAX stem keeps `reduce_window`).
`max_pool_3x3_s2_auto` is the public entry point:
  - train=True: `F.max_pool2d`, the differentiable plain path (the JAX
    function's `reduce_window` branch);
  - a CPU tensor: the twin `max_pool_3x3_s2_reference`;
  - a CUDA tensor: the kernel `csrc/max_pool.cu` (counted in
    `max_pool_3x3_s2_auto.launches`), or an error; there is no other
    fallback. The kernel takes any H and W; the TPU kernel's even-size
    limit came from its lane layout.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = ["max_pool_3x3_s2_auto", "max_pool_3x3_s2_reference",
           "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "centernet_lightning_torch/csrc/max_pool.cu"
REPLACES = "centernet_lightning_tpu/ops/pallas_pool.py:89"


@functools.cache
def _launch_fn():
    from ._build import load

    fn = load("max_pool").max_pool_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def max_pool_3x3_s2_reference(x: torch.Tensor) -> torch.Tensor:
    """The twin: the max over the nine stride-2 shifted slices of x padded
    by one -inf row and column on each side. (N, H, W, C) ->
    (N, ceil(H/2), ceil(W/2), C), bitwise F.max_pool2d(x, 3, 2, 1)."""
    _, h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    out = None
    for dy in range(3):
        for dx in range(3):
            sl = xp[:, dy:dy + 2 * ho - 1:2, dx:dx + 2 * wo - 1:2]
            out = sl if out is None else torch.maximum(out, sl)
    return out.contiguous()


def max_pool_3x3_s2_auto(x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """3x3 / stride-2 / pad-1 max pool of an (N, H, W, C) map, exactly as
    `F.max_pool2d(x, 3, 2, 1)` computes it (see the module docstring for
    which implementation runs)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if train:
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    if x.device.type == "cpu":
        return max_pool_3x3_s2_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"no max pool kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    n, h, w, c = x.shape
    out = torch.empty((n, (h + 1) // 2, (w + 1) // 2, c), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launch_fn()(x.data_ptr(), out.data_ptr(), n, h, w, c,
                           int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"max_pool kernel launch failed: CUDA error {err} "
                           f"(1, invalid value, for an empty map or one past "
                           f"the grid's limits: {tuple(x.shape)})")
    max_pool_3x3_s2_auto.launches += 1
    return out


max_pool_3x3_s2_auto.launches = 0
